"""The port's streaming path against the JAX package: SOLA, crossfade, ring
shift and VAD, then ``StreamingConverter`` block by block at tiny widths
(``torch_port_helpers.tiny_xlsr``), then the two apps on the CPU.

Streaming: speech, silence, speech (the VAD gate on, so the hangover and the
silent-block path run), the same CFM noise per converted block on both sides
(the JAX side's ``jax.random.normal`` patched to pick a buffer by its key,
the port's ``noise_fn`` walking the same key sequence) and the same HiFT
draws. Emitted blocks within 2e-4 (f32; the blocks pass SOLA, whose offset
must be equal, and a crossfade), SOLA offsets and VAD decisions equal.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seedvc_tpu.dsp.vad as j_vad
import seedvc_tpu.pipelines.streaming as j_streaming
from seedvc_tpu.dsp import sola as j_sola
from seedvc_tpu_torch.apps import realtime, stream_bench
from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
from seedvc_tpu_torch.dsp import sola, vad
from seedvc_tpu_torch.pipelines import streaming
from torch_port_helpers import jax_hift_draws, tiny_xlsr

torch.set_num_threads(1)
SR = 22050
TINY = dict(block_time=0.1, crossfade_time=0.02, sola_search_time=0.01, extra_time_ce=0.3,
            extra_time_dit=0.2, extra_time_right=0.02, diffusion_steps=2, max_prompt_time=0.5)
NOISES = np.random.default_rng(99).standard_normal((5, 128, 80)).astype(np.float32)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_sola_functions_match_jax(use_native):
    rng = np.random.default_rng(0)
    chunk = rng.standard_normal(2000).astype(np.float32)
    for start, search in ((137, 400), (0, 256), (256, 256)):
        buf = chunk[start:start + 512] + 0.1 * rng.standard_normal(512).astype(np.float32)
        k = sola.sola_offset(chunk, buf, search, use_native=use_native)
        assert k == j_sola.sola_offset(chunk, buf, search, use_native=False) == start
    tail = rng.standard_normal(100).astype(np.float32)
    np.testing.assert_allclose(sola.crossfade_add(chunk[:500].copy(), tail, use_native),
                               j_sola.crossfade_add(chunk[:500].copy(), tail, False),
                               atol=1e-6)
    for n in (3, 10, 12):
        ring, block = np.arange(10, dtype=np.float32), np.arange(n, dtype=np.float32) + 100
        np.testing.assert_array_equal(sola.ring_shift_append(ring.copy(), block, use_native),
                                      j_sola.ring_shift_append(ring.copy(), block, False))
    assert all(np.array_equal(a, b) for a, b in zip(sola.fade_windows(64),
                                                    j_sola.fade_windows(64)))


def test_sola_loader_never_writes_into_native(monkeypatch, tmp_path):
    """With the prebuilt library missing, the loader compiles into the build
    directory, never into ``native/``; and loading leaves ``native/`` as it
    was."""
    before = {p.name: p.stat().st_mtime_ns for p in sola.NATIVE_DIR.iterdir()}
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return type("Done", (), {"returncode": 1})()

    monkeypatch.setattr(sola, "NATIVE_DIR", tmp_path / "native")
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "seedvc_native.cpp").write_text("")
    monkeypatch.setattr(sola, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sola.shutil, "which", lambda name: "/usr/bin/g++")
    monkeypatch.setattr(sola.subprocess, "run", fake_run)
    monkeypatch.setattr(sola, "_lib", None)
    monkeypatch.setattr(sola, "_tried", False)
    assert sola.load_native() is None
    (cmd,) = calls
    assert Path(cmd[cmd.index("-o") + 1]).parent == tmp_path / "build"
    assert list((tmp_path / "native").iterdir()) == [tmp_path / "native" / "seedvc_native.cpp"]
    monkeypatch.undo()
    sola._lib, sola._tried = None, False
    sola.load_native()
    assert {p.name: p.stat().st_mtime_ns for p in sola.NATIVE_DIR.iterdir()} == before


def _speechlike(n, f0, seed, amp=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (amp * np.sin(2 * np.pi * f0 * t) + 0.1 * amp * np.sin(2 * np.pi * 3 * f0 * t)
            + 0.002 * rng.standard_normal(n)).astype(np.float32)


def test_vad_matches_jax():
    """Per-frame decisions over speech, silence and noise; the block gate on
    a tone, on silence, on white noise and on a quiet tone."""
    wave = np.concatenate([_speechlike(SR, 140, 1), np.zeros(SR // 2, np.float32),
                           0.3 * np.random.default_rng(2).standard_normal(SR).astype(np.float32),
                           _speechlike(SR, 200, 3)])
    np.testing.assert_array_equal(vad.vad_decisions(wave, SR), j_vad.vad_decisions(wave, SR))
    for a, b in zip(vad.frame_features(wave, SR), j_vad.frame_features(wave, SR)):
        np.testing.assert_array_equal(a, b)
    assert [len(s) for s in vad.split_segments(wave, SR, min_sec=0.5)] == [
        len(s) for s in j_vad.split_segments(wave, SR, min_sec=0.5)]
    blocks = [_speechlike(2304, 150, 4), np.zeros(2304, np.float32),
              0.3 * np.random.default_rng(5).standard_normal(2304).astype(np.float32),
              _speechlike(2304, 150, 6, amp=1e-4)]
    got = [vad.is_speech_block(b, SR) for b in blocks]
    assert got == [j_vad.is_speech_block(b, SR) for b in blocks] == [True, False, False, False]


def _record(monkeypatch, module, name, log):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_streaming_matches_jax(monkeypatch):
    jvc, pvc, _ = tiny_xlsr()
    scfg_j = j_streaming.StreamConfig(**TINY)
    ref = _speechlike(SR, 230, 7)
    # 3 speech blocks, 4 silent ones (the first converted on the hangover,
    # the second fading the last tail out), 2 speech blocks
    src = _speechlike(9 * 2304, 140, 8)
    src[3 * 2304: 7 * 2304] = 0.0

    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **kw):
        if shape is not None and len(shape) == 3 and shape[-1] == 80:
            pick = jnp.take(jnp.asarray(NOISES), key[1] % len(NOISES), axis=0)
            return pick[: shape[1]][None].astype(dtype)
        return real_normal(key, shape, dtype, *a, **kw)

    j_offsets, j_speech, p_offsets, p_speech = [], [], [], []
    _record(monkeypatch, j_streaming, "sola_offset", j_offsets)
    _record(monkeypatch, j_vad, "is_speech_block", j_speech)
    _record(monkeypatch, streaming, "sola_offset", p_offsets)
    _record(monkeypatch, streaming, "is_speech_block", p_speech)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    jst = j_streaming.StreamingConverter(jvc, scfg_j)
    jst.set_reference(ref, SR)
    j_out = [jst.process_block(src[i * 2304:(i + 1) * 2304]).copy() for i in range(9)]
    monkeypatch.setattr(jax.random, "normal", real_normal)

    key = jax.random.PRNGKey(0)  # the JAX block program's key sequence

    def noise_fn(shape):
        nonlocal key
        key, sub = jax.random.split(key)
        return torch.from_numpy(NOISES[int(sub[1]) % len(NOISES)][: shape[1]][None])

    pst = streaming.StreamingConverter(pvc, streaming.StreamConfig(**TINY), noise_fn=noise_fn,
                                       draws_fn=jax_hift_draws)
    pst.set_reference(ref, SR)
    assert (pst.block, pst.window, pst.window_16k, pst.dit_frames, pst.return_samples) == (
        jst.block, jst.window, jst.window_16k, jst.dit_frames, jst.return_samples) == (
        2304, 10240, 7430, 31, 3072)
    p_out = [pst.process_block(src[i * 2304:(i + 1) * 2304]) for i in range(9)]

    assert p_speech == j_speech == [True] * 3 + [False] * 4 + [True] * 2
    assert p_offsets == j_offsets and len(p_offsets) == 5
    for i, (p, j) in enumerate(zip(p_out, j_out)):
        assert p.shape == j.shape == (2304,)
        np.testing.assert_allclose(p, j, atol=2e-4, err_msg=f"block {i}")
    assert np.abs(p_out[1]).max() > 1e-3 and np.abs(p_out[4]).max() > 0
    assert not p_out[5].any() and not p_out[6].any()
    assert set(pst.last_timings) == {"dispatch_ms", "sync_ms", "sola_ms", "gate_ms", "total_ms",
                                     "encode_ms", "cfm_ms", "vocode_ms"}
    assert pst.graph_launches is None and pst.replays == 0  # on the CPU: eager blocks


def test_streaming_needs_a_reference():
    _, pvc, _ = tiny_xlsr()
    st = streaming.StreamingConverter(pvc, streaming.StreamConfig(**TINY))
    with pytest.raises(RuntimeError, match="set_reference"):
        st.process_block(np.zeros(st.block, np.float32))


def test_stream_encoder_runs_in_f32():
    """The block program's content encoder is f32, as the JAX block program
    applies it with the f32 weights: the converter's own when it is f32, an
    f32 copy when the converter's compute dtype is lower (the offline path and
    the reference's features keep the converter's)."""
    _, pvc, _ = tiny_xlsr()
    assert streaming.StreamingConverter(pvc, streaming.StreamConfig(**TINY)).encoder is pvc.whisper
    pvc.whisper.to(torch.bfloat16)
    pvc.compute_dtype = torch.bfloat16
    st = streaming.StreamingConverter(pvc, streaming.StreamConfig(**TINY))
    assert st.encoder is not pvc.whisper
    assert {p.dtype for p in st.encoder.parameters()} == {torch.float32}
    assert {p.dtype for p in pvc.whisper.parameters()} == {torch.bfloat16}
    for a, b in zip(st.encoder.parameters(), pvc.whisper.parameters()):
        assert torch.equal(a, b.float())
    wave = torch.from_numpy(_speechlike(8000, 150, 11))[None]
    assert st.encoder(wave).dtype == torch.float32


def _tiny_streamer(args, params):
    _, pvc, _ = tiny_xlsr()
    assert args.device == "cpu" and args.preset == "xlsr_tiny"
    return streaming.StreamingConverter(pvc, streaming.StreamConfig(
        block_time=args.block_time, crossfade_time=args.crossfade_time,
        extra_time_ce=args.extra_time_ce, extra_time_dit=args.extra_time_dit,
        extra_time_right=args.extra_time_right, diffusion_steps=args.diffusion_steps,
        cfg_rate=args.cfg_rate, max_prompt_time=args.max_prompt_time,
        vad_threshold_db=args.vad_threshold_db))


def test_realtime_simulate_on_cpu(monkeypatch, tmp_path):
    """``--simulate`` through ``main`` in a temp dir with a tiny converter
    (the ``build_streamer`` seam): a finite wav of whole blocks, and the
    settings JSON written and read back by the next run."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(realtime, "build_streamer", _tiny_streamer)
    save_wav("in.wav", _speechlike(int(0.5 * 16000), 150, 9), 16000)
    save_wav("ref.wav", _speechlike(SR // 2, 220, 10), SR)
    argv = ["--reference", "ref.wav", "--simulate", "in.wav", "--output", "out.wav",
            "--device", "cpu", "--block-time", "0.1", "--extra-time-ce", "0.3",
            "--extra-time-dit", "0.2", "--diffusion-steps", "2", "--max-prompt-time", "0.5"]
    report = realtime.main(argv)
    wave, sr = load_wav("out.wav")
    n_in = -(-int(0.5 * 16000) * SR // 16000)
    assert sr == SR and report["blocks"] == -(-n_in // 2304) == 5
    assert len(wave) == 5 * 2304 and np.isfinite(wave).all()
    saved = json.load(open("configs/inuse/realtime.json"))
    assert saved["block_time"] == 0.1 and saved["diffusion_steps"] == 2
    assert realtime.load_settings()["extra_time_ce"] == 0.3


def test_stream_bench_on_cpu(monkeypatch, capsys):
    """``main`` with ``--device cpu`` and a tiny converter (the
    ``build_converter`` seam): per-block lines, the steady median, the
    occupancy and the split; the VAD gate is off, so every block converts."""
    monkeypatch.setattr(stream_bench, "build_converter",
                        lambda args: tiny_xlsr()[1] if args.device == "cpu" else None)
    res = stream_bench.main(["--device", "cpu", "--n-blocks", "4", "--steps", "2",
                             "--block-time", "0.1"])
    text = capsys.readouterr().out
    assert len(res["block_ms"]) == 4 and res["graph_launches"] is None and res["replays"] == 0
    assert all(set(t) == {"dispatch_ms", "sync_ms", "sola_ms", "gate_ms", "total_ms",
                          "encode_ms", "cfm_ms", "vocode_ms"} for t in res["timings"])
    assert "steady-state per-block" in text and "occupancy" in text
    assert text.count("block ") >= 4
