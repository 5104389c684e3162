"""Sequence-sharded sampling where an even split of T = 32 shows nothing
(see ``tests/test_torch_parallel_seq.py`` for the even cases and the
tolerances):

- T = 30 over 4 ranks (8, 8, 8, 6 rows), and T = 6 (2, 2, 2, 0: a rank
  without rows takes part in every collective);
- a time-as-token and style-as-token DiT (``xlsr_tiny``'s layout) with a
  WaveNet head at ``dilation_rate=2``: halos of 2, 4 and 8 rows, wider than
  one row and than the last rank's part;
- a tiny ``VoiceConverter(seq_shard_axis="model")`` on 2 ranks against
  the unsharded one: the sampler's mels within 1e-6 of the largest, the
  f16 wave within 1e-3 (one f16 step near 1.0);
- the halo's rows (``parallel.collectives.halo_index``) against ``F.pad``
  of the whole sequence, every rank simulated in one process.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.parallel.collectives import halo_index, split_counts
from test_torch_parallel_seq import SEQ_RUNS, TOL_PORT, _check, _mp, _v1
from test_torch_pipeline import CONTEXT, PROMPT_CAP, SR, VOC, WHISPER, _audio, _port_cfg
from torch_parallel_worker import spawn, start

torch.set_num_threads(1)


def test_uneven_split_and_prefix_tokens_with_wide_halos(tmp_path):
    """T = 30 over 4 ranks (8, 8, 8, 6); T = 6 over 4 (2, 2, 2, 0: a rank
    without rows takes part in every collective); and the prefix-token DiT
    whose WaveNet convolutions at dilations 1, 2, 4 need halos of 2, 4 and 8
    rows: 8 reaches past the last rank's 6 rows into the reflection."""
    T = 30
    uneven_run, uneven = _v1(_mp(True), T)
    empty_run, empty = _v1(_mp(True), 6)
    prefix_mp = _mp(True, time_as_token=True, style_as_token=True,
                    wavenet=dict(num_layers=3, dilation_rate=2))
    prefix_run, prefix = _v1(prefix_mp, T)
    wait = start("seq_sampler", 4, tmp_path, dict(models={
        "uneven": {**uneven, "runs": SEQ_RUNS}, "empty": {**empty, "runs": SEQ_RUNS[:1]},
        "prefix": {**prefix, "runs": SEQ_RUNS}}))
    refs = {"uneven": np.asarray(jax.jit(uneven_run)()),
            "empty": np.asarray(jax.jit(empty_run)()),
            "prefix": np.asarray(jax.jit(prefix_run)())}
    out = wait()
    for name, ref in refs.items():
        _check(name, out[name], {None: ref}, SEQ_RUNS[:1] if name == "empty" else SEQ_RUNS)


def test_seq_sharded_voice_converter_matches_unsharded(tmp_path):
    """The tiny preset with a WaveNet head and flash on: each chunk's mel
    from the sampler within 1e-6 of the largest (the tiny model's wave sits
    at the clip, so the mels are what tells), the wave within 1e-3."""
    src, ref = _audio(200, 180.0, 0), _audio(50, 240.0, 1)
    noise = np.random.default_rng(1234).standard_normal((CONTEXT, 80)).astype(np.float32)
    cfg = _port_cfg()
    mp = cfg.model_params
    cfg = dataclasses.replace(cfg, model_params=dataclasses.replace(mp, DiT=dataclasses.replace(
        mp.DiT, final_layer_type="wavenet", use_flash_attention=True)))
    out = spawn("seq_converter", 2, tmp_path, dict(
        cfg=cfg, src=src, ref=ref, sr=SR, noise=noise,
        kw=dict(whisper_cfg=WhisperEncoderConfig(**WHISPER), vocoder_cfg=BigVGANConfig(**VOC),
                prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT)))
    assert out[None].shape == out["model"].shape and out[None].size > 0
    np.testing.assert_allclose(out["model"], out[None], atol=1e-3, rtol=0)
    whole, split = out[(None, "mels")], out[("model", "mels")]
    assert len(whole) == len(split) >= 1
    for a, b in zip(whole, split):
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=TOL_PORT * scale, rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_halo_rows_equal_f_pad_of_the_whole_sequence(mode):
    """Every rank's buffer of first and last rows, joined as the all-gather
    joins them, indexed by halo_index: each rank's slab padded equals its
    rows of F.pad over the whole sequence, for splits with short and empty
    last ranks and pads wider than a rank's part."""
    rng = np.random.default_rng(0)
    for n, parts, pad in [(32, 4, 2), (30, 4, 8), (30, 4, 4), (9, 4, 2), (3, 4, 1), (17, 2, 16),
                          (5, 3, 4), (64, 2, 1)]:
        if mode == "reflect" and pad >= n:
            continue
        x = torch.from_numpy(rng.standard_normal((2, 3, n)).astype(np.float32))
        whole = F.pad(x, (pad, pad), mode=mode)
        counts = split_counts(n, parts)
        starts = np.cumsum([0, *counts])
        for r in range(parts):
            e, idx = halo_index(counts, r, pad, mode)
            bufs = []
            for p in range(parts):
                part = x[..., starts[p]:starts[p + 1]]
                h = min(e, part.shape[-1])
                buf = torch.zeros((2, 3, 2 * e))
                buf[..., :h] = part[..., :h]
                buf[..., 2 * e - h:] = part[..., part.shape[-1] - h:]
                bufs.append(buf)
            flat = torch.cat([*bufs, torch.zeros((2, 3, 1))], -1)
            rows = flat.index_select(-1, torch.from_numpy(idx))
            got = torch.cat([rows[..., :pad], x[..., starts[r]:starts[r + 1]], rows[..., pad:]],
                            -1)
            want = whole[..., starts[r]:starts[r + 1] + 2 * pad]
            assert torch.equal(got, want), (n, parts, pad, r)
