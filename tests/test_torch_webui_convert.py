"""Real conversions through the port's web UI and the JAX package's, on the
CPU at tiny sizes: tests/test_torch_pipeline.py's converters (the same flax
trees on both sides) in each server's cache under
``v1:whisper_small_wavenet``, the same position-indexed CFM noise on both
(JAX by patching ``jax.random.normal`` for the request, the port by binding
its ``convert_with_streaming`` to ``noise_fn``); a 200-frame source, so two
chunks. v2 is in tests/test_torch_webui_v2.py, on these helpers. Two
concurrent requests must each equal the same request made alone.

Limit on the int16 bodies: 34 LSB, the pipeline tests' 1e-3 on the wave
times 32767, plus one for the truncation to int16. The port's chunked flac
and wav streams must decode to its own ``/api/convert`` body exactly, and
``X-Stats`` must be JSON.
"""

import functools
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_pipeline as v1t
from seedvc_tpu.apps import webui as jwebui
from seedvc_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig
from seedvc_tpu.pipelines.convert import VoiceConverter as JVoiceConverter
from seedvc_tpu_torch.apps import webui
from seedvc_tpu_torch.dsp.flac import decode_flac
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.pipelines.convert import VoiceConverter
from test_apps_frontends import _multipart
from tests_helpers_tiny import tiny_cfg

torch.set_num_threads(1)

LSB = 34
SR, N_MELS = 22050, 80


def _v1_converters():
    jcfg = tiny_cfg()
    params = v1t._jax_params(jcfg)
    kw = dict(prompt_cap_frames=v1t.PROMPT_CAP, context_frames=v1t.CONTEXT)
    jvc = JVoiceConverter(jcfg, whisper_cfg=JWhisperEncoderConfig(**v1t.WHISPER),
                          vocoder_cfg=JBigVGANConfig(**v1t.VOC), compute_dtype=jnp.float32,
                          **kw, **params)
    pvc = VoiceConverter(v1t._port_cfg(), whisper_cfg=WhisperEncoderConfig(**v1t.WHISPER),
                         vocoder_cfg=BigVGANConfig(**v1t.VOC), device="cpu", **kw, **params)
    pvc.convert_with_streaming = functools.partial(
        VoiceConverter.convert_with_streaming, pvc, noise_fn=v1t._port_noise)
    return jvc, pvc


def serve_pair(key: str, jconv, pconv):
    """(JAX server, port server) with ``jconv`` / ``pconv`` cached under
    ``key``; shut down when the generator is closed."""
    out = []
    for mod, kw, conv in ((jwebui, {}, jconv), (webui, {"device": "cpu"}, pconv)):
        reg = mod.ConverterRegistry(**kw)
        reg._cache[key] = conv
        server = mod.make_server("127.0.0.1", 0, reg)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append(server)
    yield out
    for server in out:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def servers():
    yield from serve_pair("v1:whisper_small_wavenet", *_v1_converters())


def _wav(wave: np.ndarray) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, SR, (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def _post(server, path, fields):
    body, ctype = _multipart(fields)
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


def _jax_noise(noise):
    """jax.random.normal with the CFM's (1, T, n_mels) draws replaced by
    ``noise``'s first T rows (tests/test_torch_pipeline.py's patch)."""
    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **kw):
        if shape is not None and len(shape) == 3 and shape[-1] == N_MELS:
            return jnp.asarray(noise[: shape[1]][None]).astype(dtype)
        return real_normal(key, shape, dtype, *a, **kw)

    return fake_normal


def vc_form() -> dict:
    return {"mode": "vc", "diffusion_steps": v1t.STEPS, "cfg_rate": v1t.CFG_RATE,
            "source": ("s.wav", _wav(v1t._audio(200, 150.0, 7))),
            "target": ("r.wav", _wav(v1t._audio(v1t.PROMPT_CAP, 220.0, 8)))}


def check_convert(servers, monkeypatch, fields: dict, noise: np.ndarray, stream_fmt: str):
    """One form to both servers' /api/convert (JAX with ``noise`` patched in),
    the int16 bodies within LSB; then the port's chunked ``stream_fmt``
    stream must carry its own body's PCM. Returns the port's stats."""
    jserver, pserver = servers
    monkeypatch.setattr(jax.random, "normal", _jax_noise(noise))
    j_status, j_headers, j_body = _post(jserver, "/api/convert", fields)
    monkeypatch.undo()
    status, headers, body = _post(pserver, "/api/convert", fields)
    assert status == j_status == 200, body[:200]
    assert headers["Content-Type"] == j_headers["Content-Type"] == "audio/wav"
    stats = json.loads(headers["X-Stats"])
    assert headers["X-RTF"] == f"{stats['rtf']:.4f}"
    assert stats["chunks"] == 2 and stats["wall_seconds"] > 0
    (j_sr, j_pcm), (sr, pcm) = (wavfile.read(io.BytesIO(b)) for b in (j_body, body))
    assert sr == j_sr == SR and pcm.shape == j_pcm.shape and len(pcm) > 0
    diff = np.abs(pcm.astype(np.int32) - j_pcm.astype(np.int32)).max()
    assert diff <= LSB, diff
    s_status, s_headers, blob = _post(pserver, "/api/convert_stream",
                                      {**fields, "stream_format": stream_fmt})
    assert s_status == 200 and s_headers["Transfer-Encoding"] == "chunked"
    streamed = (decode_flac(blob)[1][:, 0] if stream_fmt == "flac"
                else np.frombuffer(blob[44:], "<i2"))
    np.testing.assert_array_equal(streamed, pcm)
    return stats


def test_convert_matches_jax_server(servers, monkeypatch):
    """vc through both servers, and the port's flac stream (the wav stream is
    held in test_two_concurrent_requests_each_equal_their_sequential_run)."""
    check_convert(servers, monkeypatch, vc_form(), v1t.NOISE, "flac")


def test_status_lists_the_converter(servers):
    _, pserver = servers
    conn = http.client.HTTPConnection("127.0.0.1", pserver.server_address[1], timeout=30)
    conn.request("GET", "/api/status")
    status = json.loads(conn.getresponse().read())
    conn.close()
    assert status == {"loaded": ["v1:whisper_small_wavenet"], "checkpoint_dir": None}


def test_two_concurrent_requests_each_equal_their_sequential_run(servers):
    """Two client threads at once: the lock serialises the conversions, and
    each response equals the same request made alone."""
    _, pserver = servers
    forms = [{**vc_form(), "seed": str(s)} for s in (0, 1)]
    # noise_fn fixes the CFM noise, so vary the reference to tell them apart
    forms[1]["target"] = ("r.wav", _wav(v1t._audio(v1t.PROMPT_CAP, 180.0, 9)))
    alone = [_post(pserver, "/api/convert", f)[2] for f in forms]
    results = [None, None]

    def run(i):
        results[i] = _post(pserver, "/api/convert", forms[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [r[0] for r in results] == [200, 200]
    assert alone[0] != alone[1]
    for (_, _, body), ref in zip(results, alone):
        assert body == ref
    # the wav stream carries the same PCM as the body
    status, _, blob = _post(pserver, "/api/convert_stream", {**forms[1], "stream_format": "wav"})
    assert status == 200
    np.testing.assert_array_equal(np.frombuffer(blob[44:], "<i2"),
                                  wavfile.read(io.BytesIO(alone[1]))[1])
