"""The port's ``VoiceConverter.convert`` against the JAX one, end to end.

Tiny shapes (tests/tests_helpers_tiny.py's model, a small BigVGAN), the same
weights carried across, the same position-indexed noise fed to both sides:
the port through ``noise_fn``, the JAX side by patching ``jax.random.normal``
as tests/test_cross_impl_pipeline.py does. The 200-frame source runs two
chunks, the last one partial (W = 128).

Tolerance on the wave: 1e-3. Both pipelines round their output to f16, where
one step near 1.0 is 4.9e-4, so f32 noise at a rounding boundary can move a
sample by a step; everything else agrees to f32 precision.
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
from seedvc_tpu.models.vc import VCModel as JVCModel
from seedvc_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig
from seedvc_tpu.pipelines.convert import VoiceConverter as JVoiceConverter
from seedvc_tpu.pipelines.convert import cosine_crossfade as j_crossfade
from seedvc_tpu.pipelines.convert import plan_chunks as j_plan_chunks
from seedvc_tpu_torch.core import config as pc
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.pipelines.convert import VoiceConverter, cosine_crossfade, plan_chunks
from tests_helpers_tiny import tiny_cfg
from torch_port_helpers import jax_init

torch.set_num_threads(1)

SR, HOP, N_MELS = 22050, 256, 80
PROMPT_CAP, CONTEXT, STEPS, CFG_RATE = 64, 192, 4, 0.7
WHISPER = dict(d_model=48, n_layers=1, n_heads=4, ffn_dim=96)
VOC = dict(upsample_initial_channel=128, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))


def _port_cfg() -> pc.SeedVCConfig:
    """tests_helpers_tiny.tiny_cfg, field for field, in the port's classes."""
    j = tiny_cfg()
    mp = j.model_params
    return pc.SeedVCConfig(
        preprocess_params=pc.PreprocessConfig(
            sr=j.sr, spect_params=pc.SpectConfig(**dataclasses.asdict(
                j.preprocess_params.spect_params))),
        model_params=pc.ModelParams(
            length_regulator=pc.LengthRegulatorConfig(**dataclasses.asdict(mp.length_regulator)),
            DiT=pc.DiTConfig(**dataclasses.asdict(mp.DiT)),
            wavenet=pc.WavenetConfig(**dataclasses.asdict(mp.wavenet))))


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


@pytest.fixture(scope="module")
def converters():
    jcfg = tiny_cfg()
    params = _jax_params(jcfg)
    jvc = JVoiceConverter(jcfg, whisper_cfg=JWhisperEncoderConfig(**WHISPER),
                          prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT,
                          vocoder_cfg=JBigVGANConfig(**VOC), compute_dtype=jnp.float32,
                          **params)
    pvc = VoiceConverter(_port_cfg(), whisper_cfg=WhisperEncoderConfig(**WHISPER),
                         prompt_cap_frames=PROMPT_CAP, context_frames=CONTEXT,
                         vocoder_cfg=BigVGANConfig(**VOC), device="cpu", **params)
    return jvc, pvc


def _audio(n_frames, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


NOISE = np.random.default_rng(1234).standard_normal((CONTEXT, N_MELS)).astype(np.float32)


def _run_jax(jvc, src, ref, monkeypatch):
    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **kw):
        if shape is not None and len(shape) == 3 and shape[-1] == N_MELS:
            return jnp.asarray(NOISE[: shape[1]][None]).astype(dtype)
        return real_normal(key, shape, dtype, *a, **kw)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    try:
        return jvc.convert(src, SR, ref, SR, diffusion_steps=STEPS, cfg_rate=CFG_RATE)
    finally:
        monkeypatch.setattr(jax.random, "normal", real_normal)


def _port_noise(shape):
    return torch.from_numpy(NOISE[: shape[1]][None])


def test_convert_matches_jax_two_chunks_partial_last(converters, monkeypatch):
    jvc, pvc = converters
    src, ref = _audio(200, 150.0, 7), _audio(PROMPT_CAP, 220.0, 8)
    _, j_wave, j_stats = _run_jax(jvc, src, ref, monkeypatch)
    _, p_wave, p_stats = pvc.convert(src, SR, ref, SR, diffusion_steps=STEPS,
                                     cfg_rate=CFG_RATE, noise_fn=_port_noise)
    assert p_stats["chunks"] == j_stats["chunks"] == 2
    assert p_wave.shape == j_wave.shape == (200 * HOP,)
    np.testing.assert_allclose(p_wave, j_wave, atol=1e-3)
    snr = 10 * np.log10(np.mean(j_wave ** 2) / max(np.mean((j_wave - p_wave) ** 2), 1e-20))
    assert snr > 60.0, snr


def test_streaming_pieces_join_to_convert(converters):
    _, pvc = converters
    src, ref = _audio(200, 180.0, 9), _audio(50, 130.0, 10)
    kw = dict(diffusion_steps=2, cfg_rate=CFG_RATE, seed=3)
    _, wave, _ = pvc.convert(src, SR, ref, SR, **kw)
    pieces = [p for _, p, _ in pvc.convert_with_streaming(src, SR, ref, SR, **kw)]
    assert len(pieces) == 2
    np.testing.assert_array_equal(np.concatenate(pieces), wave)


@pytest.mark.parametrize("target_len,p_len,max_context,prompt_cap", [
    (2583, 430, 2560, 768), (400, 100, 2560, 768), (9000, 700, 2560, 768),
    (200, 64, 192, 64), (1200, 900, 2560, 768)])
def test_plan_chunks_matches_jax(target_len, p_len, max_context, prompt_cap):
    assert (plan_chunks(target_len, p_len, max_context, prompt_cap)
            == j_plan_chunks(target_len, p_len, max_context, prompt_cap))


def test_cosine_crossfade_matches_jax():
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal(4096), rng.standard_normal(3000)
    np.testing.assert_array_equal(cosine_crossfade(a, b, 4096), j_crossfade(a, b, 4096))


WARM_SPECS = [(30.0, 5.0), (10.0, 5.0), (30.0, 5.0), (10.0, 5.2), (5.0, 3.0), (0.5, 40.0)]


def test_warm_returns_jax_plans_one_conversion_each(converters, monkeypatch, capsys):
    """``warm`` on both converters with the flagship's window (context 2560,
    prompt cap 768) set on them and ``convert`` recorded: the same plans,
    without repeats, and one silent conversion per plan at the given steps
    and rate."""
    seen = []
    for vc in converters:
        calls = []
        monkeypatch.setattr(vc, "context", 2560)
        monkeypatch.setattr(vc, "prompt_cap", 768)
        monkeypatch.setattr(vc, "convert", lambda src, ssr, ref, rsr, calls=calls, **kw:
                            calls.append((len(src), ssr, len(ref), rsr,
                                          float(np.abs(src).max()), kw)))
        plans = vc.warm(WARM_SPECS, diffusion_steps=7, cfg_rate=0.4)
        seen.append((plans, calls))
    (j_plans, j_calls), (plans, calls) = seen
    assert plans == j_plans and len(set(plans)) == len(plans) == 4
    assert calls == j_calls and len(calls) == len(plans)
    assert all(c[4] == 0.0 and c[5] == {"diffusion_steps": 7, "cfg_rate": 0.4} for c in calls)
    assert capsys.readouterr().out.count("warmed (prompt_cap, context, W)") == 4


def test_warm_converts_on_the_cpu(converters, capsys):
    _, pvc = converters
    plans = pvc.warm([(0.5, 0.2), (0.6, 0.2)], diffusion_steps=1)
    assert plans == [pvc.plan_chunks(43, 17)] == [(PROMPT_CAP, CONTEXT, CONTEXT - PROMPT_CAP)]
    assert "warmed" in capsys.readouterr().out
