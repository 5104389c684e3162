"""The port's streaming FLAC encoder (seedvc_tpu_torch/dsp/flac.py) against
the JAX package's (seedvc_tpu/dsp/flac.py). Host code on both sides, so the
limit is exact: the port's stream equals JAX's byte for byte (header and
frames, for speech-like, constant, white-noise, float, stereo and long
input, and for one stream cut into chunks in several ways), each decoder
reads the other's stream back to the same int16 PCM, and the five cases of
tests/test_flac.py hold on the port."""

import numpy as np
import pytest

from seedvc_tpu.dsp import flac as jflac
from seedvc_tpu_torch.dsp import flac as pflac
from seedvc_tpu_torch.dsp.flac import StreamingFlacEncoder, _utf8_coded_number, decode_flac


def speechlike(n, sr=22050, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    sig = 0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
    sig += np.convolve(rng.standard_normal(n) * 0.05, np.ones(8) / 8, "same")
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def _noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 20000).clip(-32768, 32767).astype(np.int16)


def _stream(mod, pcm, sr=22050, channels=1, splits=None):
    enc = mod.StreamingFlacEncoder(sr, channels)
    bounds = [0, *(splits or []), len(pcm)]
    return enc.header() + b"".join(enc.encode(pcm[lo:hi]) for lo, hi in zip(bounds, bounds[1:]))


# -- the cases of tests/test_flac.py, on the port ---------------------------

def test_coded_number_matches_utf8():
    assert _utf8_coded_number(0x41) == "A".encode()
    assert _utf8_coded_number(0xE9) == "é".encode()
    assert _utf8_coded_number(0x20AC) == "€".encode()
    assert _utf8_coded_number((1 << 36) - 1) == bytes([0xFE] + [0xBF] * 6)
    with pytest.raises(ValueError):
        _utf8_coded_number(1 << 36)


def test_round_trip_lossless_and_compressed():
    sr = 22050
    pcm = speechlike(3 * sr)
    pcm[:1000] = 0
    pcm[5000:5100] = 12345
    enc = StreamingFlacEncoder(sr)
    blob = enc.header() + enc.encode(pcm)
    assert blob[:4] == b"fLaC"
    assert len(blob) < len(pcm) * 2 * 0.8
    dsr, dec = decode_flac(blob)
    assert dsr == sr
    np.testing.assert_array_equal(dec[:, 0], pcm)


def test_streaming_chunked_encode_equals_whole():
    pcm = speechlike(50000, seed=1)
    _, dec = decode_flac(_stream(pflac, pcm, splits=[7000, 23384, 43384]))
    np.testing.assert_array_equal(dec[:, 0], pcm)


def test_noise_falls_back_verbatim_losslessly():
    noise = _noise(3000)
    enc = StreamingFlacEncoder(22050)
    _, dec = decode_flac(enc.header() + enc.encode(noise))
    np.testing.assert_array_equal(dec[:, 0], noise)


def test_float_input_and_long_blocks():
    sr = 44100
    n = 3 * StreamingFlacEncoder.MAX_BLOCK + 123
    wave = 0.25 * np.sin(2 * np.pi * 440 * np.arange(n) / sr).astype(np.float32)
    enc = StreamingFlacEncoder(sr)
    dsr, dec = decode_flac(enc.header() + enc.encode(wave))
    assert dsr == sr and dec.shape[0] == n
    np.testing.assert_array_equal(dec[:, 0], (np.clip(wave, -1, 1) * 32767).astype(np.int16))


# -- byte equality with the JAX package's encoder ----------------------------

def _constant():
    pcm = np.full(4000, -1234, np.int16)
    pcm[2000:] = 0
    return pcm


def _stereo():
    return np.stack([speechlike(6000, seed=3), _noise(6000, seed=4)], axis=1)


def _float():
    t = np.arange(9000) / 22050
    return (0.4 * np.sin(2 * np.pi * 180 * t) * np.hanning(9000)).astype(np.float32)


CASES = {
    "speech": lambda: (speechlike(3 * 22050), 22050, 1),
    "constant": lambda: (_constant(), 22050, 1),
    "white_noise_verbatim": lambda: (_noise(5000, seed=2), 22050, 1),
    "float": lambda: (_float(), 22050, 1),
    "stereo": lambda: (_stereo(), 44100, 2),
    "long_blocks": lambda: (speechlike(2 * StreamingFlacEncoder.MAX_BLOCK + 777, 44100, 5),
                            44100, 1),
    "short_blocks": lambda: (speechlike(64, seed=6)[:5], 22050, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_bytes_equal_jax(case):
    pcm, sr, ch = CASES[case]()
    assert (pflac.StreamingFlacEncoder(sr, ch).header()
            == jflac.StreamingFlacEncoder(sr, ch).header())
    port, ref = _stream(pflac, pcm, sr, ch), _stream(jflac, pcm, sr, ch)
    assert port == ref


@pytest.mark.parametrize("splits", [[1], [7000, 23384, 43384], [16384, 32768],
                                    [1000, 1001, 1002, 40000]],
                         ids=["one_sample_head", "pipeline_pieces", "max_block_edges",
                              "tiny_chunks"])
def test_chunked_stream_bytes_equal_jax(splits):
    pcm = speechlike(50000, seed=7)
    port = _stream(pflac, pcm, splits=splits)
    assert port == _stream(jflac, pcm, splits=splits)
    # frames carry their sample positions: the split stream decodes whole
    np.testing.assert_array_equal(decode_flac(port)[1][:, 0], pcm)


@pytest.mark.parametrize("case", ["speech", "white_noise_verbatim", "stereo", "long_blocks"])
def test_decoders_read_each_others_streams(case):
    pcm, sr, ch = CASES[case]()
    j_blob = _stream(jflac, pcm, sr, ch)
    p_sr, p_dec = pflac.decode_flac(j_blob)
    j_sr, j_dec = jflac.decode_flac(_stream(pflac, pcm, sr, ch))
    assert p_sr == j_sr == sr
    np.testing.assert_array_equal(p_dec, j_dec)
    np.testing.assert_array_equal(p_dec, pcm.reshape(len(pcm), ch))


def test_coded_numbers_equal_jax():
    for n in (0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 1 << 30, (1 << 36) - 1):
        assert pflac._utf8_coded_number(n) == jflac._utf8_coded_number(n)
    data = bytes(range(256)) * 3
    assert pflac._crc8(data) == jflac._crc8(data)
    assert pflac._crc16(data) == jflac._crc16(data)
