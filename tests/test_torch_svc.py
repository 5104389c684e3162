"""SVC (F0-conditioned conversion) in the port against the JAX package, on
the CPU: ``f0_to_coarse``, the regulator's F0 branch and the whole
``VoiceConverter.convert`` on ``tests_helpers_tiny.tiny_f0_cfg()``.

The conversion test carries the same weights to both sides, feeds the same
position-indexed noise (as tests/test_torch_pipeline.py does) and replaces
RMVPE on both sides by one stub that returns fixed tracks (as
tests/test_cross_impl_pipeline.py injects them; RMVPE itself is held to JAX
in tests/test_torch_rmvpe.py), so it tests the F0 composition: median-log
matching with the lower median, the semitone shift, the 256-frame F0 bucket
with its true length, ``f0_to_coarse`` and the pitch embedding.
Tolerances: regulator outputs 1e-5 (f32 order); the wave 1e-3 (both sides
round it to f16, one step near 1.0 is 4.9e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.models.bigvgan import BigVGAN as JBigVGAN
from seedvc_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from seedvc_tpu.models.campplus import CAMPPlus as JCAMPPlus
from seedvc_tpu.models.regulator import InterpolateRegulator as JRegulator
from seedvc_tpu.models.regulator import f0_to_coarse as j_f0_to_coarse
from seedvc_tpu.models.vc import VCModel as JVCModel
from seedvc_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig
from seedvc_tpu.pipelines.convert import VoiceConverter as JVoiceConverter
from seedvc_tpu_torch.core import config as pc
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.regulator import (
    F0_MEL_MAX, F0_MEL_MIN, InterpolateRegulator, f0_to_coarse)
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.pipelines.convert import VoiceConverter
from seedvc_tpu_torch.weights import load_jax_params
from tests_helpers_tiny import tiny_f0_cfg
from torch_port_helpers import jax_apply, jax_init

torch.set_num_threads(1)

SR, HOP, N_MELS = 22050, 256, 80
PROMPT_CAP, CONTEXT, STEPS, CFG_RATE = 64, 192, 4, 0.7
WHISPER = dict(d_model=48, n_layers=1, n_heads=4, ffn_dim=96)
VOC = dict(upsample_initial_channel=128, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))


def port_cfg(j: pc.SeedVCConfig) -> pc.SeedVCConfig:
    """A JAX-package config, field for field, in the port's classes."""
    mp = j.model_params
    return pc.SeedVCConfig(
        preprocess_params=pc.PreprocessConfig(
            sr=j.sr, spect_params=pc.SpectConfig(**dataclasses.asdict(
                j.preprocess_params.spect_params))),
        model_params=pc.ModelParams(
            length_regulator=pc.LengthRegulatorConfig(**dataclasses.asdict(mp.length_regulator)),
            DiT=pc.DiTConfig(**dataclasses.asdict(mp.DiT)),
            wavenet=pc.WavenetConfig(**dataclasses.asdict(mp.wavenet))))


@pytest.mark.parametrize("f0_bin", [256, 64])
def test_f0_to_coarse_matches_jax(f0_bin):
    """0 Hz (bin 1), the 50 and 1100 Hz ends, values past 1100 (which wrap to
    bin 0) and the half-bin points. XLA's f32 ``log`` and PyTorch's differ in
    the last place on some inputs, so the bins must be equal wherever the two
    f32 mel values are, and within one bin elsewhere; where the port's mel
    is exactly k + 0.5, it must round to the even neighbour (``jnp.round``'s
    rule)."""
    a = (f0_bin - 2) / (F0_MEL_MAX - F0_MEL_MIN)
    b = F0_MEL_MIN * a - 1.0
    half = (np.arange(1, f0_bin) + 0.5 + b) / a
    half_hz = 700.0 * (np.exp(half / 1127.0) - 1.0)
    grid = np.concatenate([[0.0, 1e-3, 20.0, 50.0, 1100.0, 1100.5, 1200.0, 5000.0],
                           np.linspace(0, 1500, 3001), half_hz,
                           np.nextafter(half_hz, 0), np.nextafter(half_hz, 2e3)]).astype(np.float32)
    ref = np.asarray(j_f0_to_coarse(jnp.asarray(grid), f0_bin))
    tg = torch.from_numpy(grid)
    out = f0_to_coarse(tg, f0_bin).numpy()
    mel_j = np.asarray(1127.0 * jnp.log(1.0 + jnp.asarray(grid) / 700.0) * a - b)
    mel_t = (1127.0 * torch.log(1.0 + tg / 700.0) * a - b).numpy()
    same = mel_j == mel_t
    assert same.mean() > 0.75
    np.testing.assert_array_equal(out[same], ref[same])
    assert np.abs(out.astype(np.int64) - ref).max() <= 1
    on_half = (mel_t > 0) & (np.mod(mel_t, 1.0) == 0.5) & (mel_t < f0_bin - 1)
    assert on_half.sum() > 0
    np.testing.assert_array_equal(out[on_half], 2 * np.round(mel_t[on_half] / 2))
    assert out[0] == 1 and out[4] == f0_bin - 1 and out[6] == out[7] == 0


def _track(n: int, seed: int, even: bool = True) -> np.ndarray:
    """An F0 track in Hz, about 30% unvoiced, with an even voiced count."""
    rng = np.random.default_rng(seed)
    f0 = (100.0 * 2 ** rng.uniform(0, 2, n)).astype(np.float32)
    f0[rng.uniform(size=n) < 0.3] = 0.0
    if even and (f0 > 1).sum() % 2:
        f0[np.argmax(f0 > 1)] = 0.0
    return f0


@pytest.mark.parametrize("with_f0", [True, False], ids=["f0", "mask"])
def test_f0_regulator_matches_jax(with_f0):
    """A 300-frame F0 (no multiple of 256) in a 512-frame bucket with its true
    length, 50 content tokens in a 64-token buffer, ylens 200 in a 256-frame
    output; or no F0 (the learned mask). Dropping ``f0_lens`` must change
    the output: the zero pad's bin 1 would be read."""
    jcfg = tiny_f0_cfg().model_params.length_regulator
    x = np.random.default_rng(1).standard_normal((1, 64, jcfg.in_channels)).astype(np.float32)
    f0 = np.zeros((1, 512), np.float32)
    f0[0, :300] = _track(300, 2)
    ylens = np.array([200], np.int32)
    jm = JRegulator(jcfg)
    kw = dict(target_len=256, x_lens=jnp.asarray(50))
    jf0 = jnp.asarray(f0) if with_f0 else None
    if with_f0:
        kw["f0_lens"] = jnp.asarray(300)
    params = jax_init(jm, jnp.asarray(x), jnp.asarray(ylens), f0=jf0, seed=3, **kw)
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(x), jnp.asarray(ylens), f0=jf0, **kw)[0])
    pm = load_jax_params(InterpolateRegulator(port_cfg(tiny_f0_cfg()).model_params
                                              .length_regulator), params)
    tf0 = torch.from_numpy(f0) if with_f0 else None
    f0_lens = torch.tensor(300) if with_f0 else None
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(ylens), 256, tf0,
                 x_lens=torch.tensor(50), f0_lens=f0_lens)[0].numpy()
        if with_f0:
            no_lens = pm(torch.from_numpy(x), torch.from_numpy(ylens), 256, tf0,
                         x_lens=torch.tensor(50))[0].numpy()
            assert np.abs(no_lens - ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
def _jax_params(cfg):
    mp = cfg.model_params
    T0 = 32
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    key = jax.random.PRNGKey(0)
    return dict(
        whisper_params=jax_init(JWhisperEncoder(JWhisperEncoderConfig(**WHISPER)),
                                z(1, 3000, 80), seed=1),
        campplus_params=jax_init(JCAMPPlus(), z(1, 300, 80), seed=2),
        vc_params=jax_init(JVCModel(mp), z(1, T0, 48), z(1, T0, 48), z(1, T0, N_MELS),
                           jnp.full((1,), T0, jnp.int32), z(1, 192), seed=3,
                           deterministic=True,
                           rngs_dict={"prompt": key, "t": key, "noise": key, "drop": key}),
        vocoder_params=jax_init(JBigVGAN(JBigVGANConfig(**VOC)), z(1, 16, N_MELS), seed=4))


class StubRMVPE:
    """Fixed F0 tracks by frame count (1 + samples // 160), the same on both
    sides; records the lengths it was asked for."""

    def __init__(self):
        self.calls = []

    def infer_from_audio_batch(self, waves, thred=0.03, timer=None, keep=None):
        n = 1 + waves.shape[-1] // 160
        self.calls.append(n)
        return _track(n, seed=n)[None]


def _record(obj, name, store):
    real = getattr(obj, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        store.append(out)
        return out

    return wrapped


NOISE = np.random.default_rng(1234).standard_normal((CONTEXT, N_MELS)).astype(np.float32)


@pytest.fixture(scope="module")
def converters():
    jcfg = tiny_f0_cfg()
    params = _jax_params(jcfg)
    # any rmvpe tree keeps the JAX converter from initialising a full RMVPE;
    # the stub replaces the model on both sides
    jvc = JVoiceConverter(jcfg, whisper_cfg=JWhisperEncoderConfig(**WHISPER),
                          prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT,
                          vocoder_cfg=JBigVGANConfig(**VOC), compute_dtype=jnp.float32,
                          rmvpe_params={}, **params)
    pvc = VoiceConverter(port_cfg(jcfg), whisper_cfg=WhisperEncoderConfig(**WHISPER),
                         prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT,
                         vocoder_cfg=BigVGANConfig(**VOC), device="cpu", **params)
    return jvc, pvc


def _audio(n_frames, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def test_svc_convert_matches_jax(converters, monkeypatch):
    jvc, pvc = converters
    src, ref = _audio(200, 150.0, 7), _audio(PROMPT_CAP, 220.0, 8)
    kw = dict(diffusion_steps=STEPS, cfg_rate=CFG_RATE, auto_f0_adjust=True, pitch_shift=2.0)
    j_stub, p_stub = StubRMVPE(), StubRMVPE()
    monkeypatch.setattr(jvc, "rmvpe", j_stub)
    monkeypatch.setattr(pvc, "rmvpe", p_stub)
    j_f0s, p_f0s, j_conds, p_conds = [], [], [], []
    monkeypatch.setattr(jvc, "extract_f0", _record(jvc, "extract_f0", j_f0s))
    monkeypatch.setattr(pvc, "extract_f0", _record(pvc, "extract_f0", p_f0s))
    monkeypatch.setattr(jvc, "_regulate_bucketed", _record(jvc, "_regulate_bucketed", j_conds))
    monkeypatch.setattr(pvc, "_regulate_bucketed", _record(pvc, "_regulate_bucketed", p_conds))

    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **k):
        if shape is not None and len(shape) == 3 and shape[-1] == N_MELS:
            return jnp.asarray(NOISE[: shape[1]][None]).astype(dtype)
        return real_normal(key, shape, dtype, *a, **k)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    _, j_wave, j_stats = jvc.convert(src, SR, ref, SR, **kw)
    monkeypatch.setattr(jax.random, "normal", real_normal)
    _, p_wave, p_stats = pvc.convert(src, SR, ref, SR,
                                     noise_fn=lambda s: torch.from_numpy(NOISE[: s[1]][None]),
                                     **kw)

    # the stub saw the same lengths: reference first, then source; neither
    # track length is a multiple of 256
    assert p_stub.calls == j_stub.calls and len(p_stub.calls) == 2
    assert all(n % 256 for n in p_stub.calls)
    (p_alt, p_ori), = p_f0s
    (j_alt, j_ori), = j_f0s
    np.testing.assert_array_equal(p_alt, j_alt)
    np.testing.assert_array_equal(p_ori, j_ori)
    # the lower median is what makes them equal: with np.median's mean of the
    # two middle values (both voiced counts are even) the shift differs
    alt_raw, ori_raw = _track(p_stub.calls[1], p_stub.calls[1]), _track(p_stub.calls[0],
                                                                        p_stub.calls[0])
    va, vo = alt_raw > 1, ori_raw > 1
    assert va.sum() % 2 == 0 and vo.sum() % 2 == 0
    mean_med = (np.log(alt_raw + 1e-5)[va] - np.median(np.log(alt_raw[va] + 1e-5))
                + np.median(np.log(ori_raw[vo] + 1e-5)))
    assert np.abs(np.exp(mean_med) * 2 ** (2 / 12) - p_alt[va]).max() > 1e-3

    assert len(p_conds) == len(j_conds) == 2
    for p_c, j_c in zip(p_conds, j_conds):
        np.testing.assert_allclose(p_c.numpy(), np.asarray(j_c), atol=1e-5, rtol=0)
    assert p_stats["chunks"] == j_stats["chunks"] == 2
    assert p_wave.shape == j_wave.shape == (200 * HOP,)
    np.testing.assert_allclose(p_wave, j_wave, atol=1e-3)
    assert "f0" in p_stats["stages"] and "f0" in j_stats["stages"]
