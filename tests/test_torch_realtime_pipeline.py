"""The port's ``VoiceConverter.convert`` with the real-time model set
(``xlsr_tiny``: SSL content encoder, DiT with time and style tokens, HiFT)
against the JAX one, end to end, at tiny widths (``torch_port_helpers.
tiny_xlsr``) on the same weights.

The same position-indexed CFM noise goes to both sides (the port through
``noise_fn``, the JAX side by patching ``jax.random.normal`` for mel-shaped
draws, as tests/test_torch_pipeline.py does), and the same HiFT draws (the
JAX pipeline's ``PRNGKey(0)`` ones, given to the port through ``draws_fn``).
The 200-frame source runs two chunks, the last one partial (W = 128).

Tolerance on the wave: 1e-3, as the main path's test: both pipelines round
their output to f16 (one step near 1.0 is 4.9e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_hift_draws, tiny_xlsr

torch.set_num_threads(1)

SR, HOP, N_MELS, PROMPT_CAP, CONTEXT, STEPS, CFG_RATE = 22050, 256, 80, 64, 192, 4, 0.7
NOISE = np.random.default_rng(1234).standard_normal((CONTEXT, N_MELS)).astype(np.float32)


@pytest.fixture(scope="module")
def converters():
    jvc, pvc, _ = tiny_xlsr(PROMPT_CAP, CONTEXT)
    return jvc, pvc


def _audio(n_frames, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def test_xlsr_hift_convert_matches_jax(converters, monkeypatch):
    jvc, pvc = converters
    src, ref = _audio(200, 150.0, 7), _audio(PROMPT_CAP, 220.0, 8)
    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **kw):
        if shape is not None and len(shape) == 3 and shape[-1] == N_MELS:
            return jnp.asarray(NOISE[: shape[1]][None]).astype(dtype)
        return real_normal(key, shape, dtype, *a, **kw)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    _, j_wave, j_stats = jvc.convert(src, SR, ref, SR, diffusion_steps=STEPS, cfg_rate=CFG_RATE)
    monkeypatch.setattr(jax.random, "normal", real_normal)
    shapes = []

    def draws_fn(shape):
        shapes.append(shape)
        return jax_hift_draws(shape)

    _, p_wave, p_stats = pvc.convert(src, SR, ref, SR, diffusion_steps=STEPS, cfg_rate=CFG_RATE,
                                     noise_fn=lambda s: torch.from_numpy(NOISE[: s[1]][None]),
                                     draws_fn=draws_fn)
    assert shapes == [(1, (CONTEXT - PROMPT_CAP) * HOP, 9)]
    assert p_stats["chunks"] == j_stats["chunks"] == 2
    assert p_wave.shape == j_wave.shape == (200 * HOP,)
    np.testing.assert_allclose(p_wave, j_wave, atol=1e-3)
    snr = 10 * np.log10(np.mean(j_wave ** 2) / max(np.mean((j_wave - p_wave) ** 2), 1e-20))
    assert snr > 60.0, snr


def test_xlsr_semantic_features_match_jax(converters):
    """SSL features of a 7 s piece (padded to the 10 s bucket, cropped to
    len // 320) and of a 0.3 s one (padded to the 8000-sample floor's 5 s
    bucket); f32 -> 1e-4."""
    jvc, pvc = converters
    for n in (7 * 16000 + 123, 4800):
        wave = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.1
        ref = np.asarray(jvc.semantic_features(wave))
        out = pvc.semantic_features(wave).numpy()
        assert out.shape == ref.shape == (1, n // 320, 64)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
