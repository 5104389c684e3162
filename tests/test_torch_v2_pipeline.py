"""The port's ``VoiceConverterV2`` against the JAX one, end to end on the
CPU: tiny models (tests/test_pipeline_v2.py::tiny_v2 and the small BigVGAN
of tests/test_torch_pipeline.py), every tree drawn by
``torch_port_helpers.jax_init`` and passed to both through ``params=``, 2
diffusion steps. Both sides get the same CFM noise (the port through
``noise_fn``, JAX by patching ``jax.random.normal`` as
tests/test_torch_pipeline.py does) and the same AR draws (JAX's, replayed by
``torch_port_helpers.jax_ar_draws``).

Tolerance on the wave: 1e-3, as in the v1 test (both round the output to
f16, one step near 1.0 is 4.9e-4); the AR's tokens and counts are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seedvc_tpu.pipelines.convert_v2 as jconv
import seedvc_tpu_torch.pipelines.convert_v2 as pconv
from seedvc_tpu.core.config import LengthRegulatorConfig as JRegCfg
from seedvc_tpu.models.ar import ARTransformer as JAR
from seedvc_tpu.models.astral import AstralQuantizer as JAstral
from seedvc_tpu.models.bigvgan import BigVGAN as JBigVGAN
from seedvc_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from seedvc_tpu.models.campplus import CAMPPlus as JCAMPPlus
from seedvc_tpu.models.dit_v2 import DiTV2 as JDiTV2
from seedvc_tpu.models.regulator import InterpolateRegulator as JReg
from seedvc_tpu.models.ssl import SSLEncoder as JSSL
from seedvc_tpu_torch.apps import infer_v2, microbench
from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
from seedvc_tpu_torch.models.ar import ARConfig
from seedvc_tpu_torch.models.astral import AstralConfig
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
from seedvc_tpu_torch.models.ssl import SSLConfig
from test_pipeline_v2 import tiny_v2
from test_torch_pipeline import VOC
from torch_port_helpers import jax_ar_draws, jax_init

torch.set_num_threads(1)

SR, HOP, N_MELS, STEPS = 22050, 256, 80, 2
EOS_BIAS = 3.0
# asymmetric (intelligibility, similarity) rates: the three-way CFG stack
RATES = dict(intelligibility_cfg_rate=0.3, similarity_cfg_rate=0.9)


def _port_cfg(j: jconv.V2Config) -> pconv.V2Config:
    def same(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})

    return pconv.V2Config(
        dit=same(DiTV2Config, j.dit), ar=same(ARConfig, j.ar), ssl=same(SSLConfig, j.ssl),
        narrow=same(AstralConfig, j.narrow), wide=same(AstralConfig, j.wide),
        prompt_cap_frames=j.prompt_cap_frames, context_frames=j.context_frames)


def _jax_params(cfg: jconv.V2Config) -> dict:
    """Random trees for the nine modules; the AR's EOS column gets +EOS_BIAS
    so that its decode ends (at random weights it would run to 2048)."""
    z = jnp.zeros
    reg = dict(is_discrete=True)
    ar = JAR(cfg.ar)
    params = {
        "ssl": jax_init(JSSL(cfg.ssl), z((1, 16000)), seed=1),
        "narrow": jax_init(JAstral(cfg.narrow), z((1, 50, cfg.ssl.d_model)), seed=2),
        "wide": jax_init(JAstral(cfg.wide), z((1, 50, cfg.ssl.d_model)), seed=3),
        "campplus": jax_init(JCAMPPlus(feat_dim=80, embedding_size=cfg.dit.style_encoder_dim),
                             z((1, 300, 80)), seed=4),
        "cfm_reg": jax_init(JReg(JRegCfg(channels=cfg.dit.content_dim,
                                         content_codebook_size=cfg.wide.codebook_size,
                                         sampling_ratios=(1, 1, 1, 1), **reg)),
                            z((1, 8), jnp.int32), jnp.array([16]), 16, seed=5),
        "ar_reg": jax_init(JReg(JRegCfg(channels=cfg.ar.dim,
                                        content_codebook_size=cfg.narrow.codebook_size,
                                        sampling_ratios=(), **reg)),
                           z((1, 8), jnp.int32), jnp.array([8]), 8, seed=6),
        "dit": jax_init(JDiTV2(cfg.dit), z((1, 16, N_MELS)), z((1, 16, N_MELS)), jnp.array([16]),
                        z((1,)), z((1, cfg.dit.style_encoder_dim)),
                        z((1, 16, cfg.dit.content_dim)), seed=7),
        "ar": jax_init(ar, z((1, 4), jnp.int32), jnp.arange(4)[None],
                       jnp.tril(jnp.ones((4, 4), bool))[None, None], seed=8,
                       method=ar.init_all),
        "vocoder": jax_init(JBigVGAN(JBigVGANConfig(**VOC)), z((1, 16, N_MELS)), seed=9),
    }
    params["ar"]["output"]["kernel"][:, cfg.ar.eos] += EOS_BIAS
    return params


@pytest.fixture(scope="module")
def converters():
    jcfg = tiny_v2()
    params = _jax_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "BIGVGAN_22K_80", JBigVGANConfig(**VOC))
        mp.setattr(pconv, "BIGVGAN_22K_80", BigVGANConfig(**VOC))
        jvc = jconv.VoiceConverterV2(jcfg, params=params)
        pvc = pconv.VoiceConverterV2(_port_cfg(jcfg), params=params, device="cpu")
    return jvc, pvc


def _audio(n_frames, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


CONTEXT = tiny_v2().context_frames
NOISE = np.random.default_rng(4321).standard_normal((CONTEXT, N_MELS)).astype(np.float32)


def _port_noise(shape):
    return torch.from_numpy(NOISE[: shape[1]][None])


def _jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    return lambda shape: jax_ar_draws(key, shape[1], shape[2], shape[0])


def _both(converters, monkeypatch, src, ref, seed=0, **kw):
    jvc, pvc = converters
    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **k):
        if shape is not None and len(shape) == 3 and shape[-1] == N_MELS:
            return jnp.asarray(NOISE[: shape[1]][None]).astype(dtype)
        return real_normal(key, shape, dtype, *a, **k)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    try:
        j = jvc.convert_voice(src, SR, ref, SR, diffusion_steps=STEPS, seed=seed, **kw)
    finally:
        monkeypatch.setattr(jax.random, "normal", real_normal)
    p = pvc.convert_voice(src, SR, ref, SR, diffusion_steps=STEPS, seed=seed,
                          noise_fn=_port_noise, draws_fn=_jax_draws(seed), **kw)
    return j, p


def _check(j, p):
    (_, j_wave, j_stats), (_, p_wave, p_stats) = j, p
    assert p_stats["wide_tokens"] == j_stats["wide_tokens"]
    assert p_stats["ar_batch"] == j_stats["ar_batch"]
    assert p_wave.shape == j_wave.shape and len(p_wave) > 0
    np.testing.assert_allclose(p_wave, j_wave, atol=1e-3)
    return p_stats


def test_convert_timbre_matches_jax(converters, monkeypatch):
    """150 source frames in W = 96 windows: two chunks, the last partial."""
    src, ref = _audio(150, 150.0, 7), _audio(40, 220.0, 8)
    j, p = _both(converters, monkeypatch, src, ref, convert_style=False, **RATES)
    stats = _check(j, p)
    assert stats["ar_batch"] == 0 and stats["chunks"] == 2
    assert len(p[1]) == 150 * HOP


def test_convert_voice_matches_jax(converters, monkeypatch):
    """The AR route: wide tokens from one batched decode, and an output
    length that follows the AR's token ratio."""
    src, ref = _audio(120, 140.0, 9), _audio(40, 200.0, 10)
    j, p = _both(converters, monkeypatch, src, ref, seed=3, top_p=0.8, temperature=0.9,
                 repetition_penalty=1.2, **RATES)
    stats = _check(j, p)
    assert stats["ar_batch"] == 1 and stats["decode_steps"] >= stats["wide_tokens"] - 1
    assert stats["target_len"] == max(int(120 / stats["narrow_tokens"] * stats["wide_tokens"]),
                                      1)


def test_anonymization_matches_jax(converters, monkeypatch):
    src, ref = _audio(100, 160.0, 11), _audio(40, 240.0, 12)
    j, p = _both(converters, monkeypatch, src, ref, seed=5, anonymization_only=True)
    assert _check(j, p)["ar_batch"] == 1


def test_streaming_pieces_join_to_convert_voice(converters):
    _, pvc = converters
    src, ref = _audio(180, 170.0, 13), _audio(30, 210.0, 14)
    kw = dict(diffusion_steps=STEPS, seed=4, convert_style=False)
    _, wave, stats = pvc.convert_voice(src, SR, ref, SR, **kw)
    pieces = [p for _, p, _ in pvc.convert_voice_with_streaming(src, SR, ref, SR, **kw)]
    assert len(pieces) == stats["chunks"] >= 2
    np.testing.assert_array_equal(np.concatenate(pieces), wave)


def test_warm_runs_one_silent_conversion_per_plan(converters, capsys):
    _, pvc = converters
    plans = pvc.warm([(1.0, 0.5), (1.0, 0.5), (2.0, 1.0)], diffusion_steps=1)
    assert plans == [pvc.plan_chunks(86, 43)] and "warmed v2" in capsys.readouterr().out


def test_infer_v2_cli_writes_a_wav(converters, monkeypatch, tmp_path):
    """``--device cpu`` reaches the converter, and the CLI writes the
    conversion as a wav (the converter is the fixture's tiny one)."""
    _, pvc = converters
    seen = {}

    def build(cfg, params=None, device=None):
        seen.update(device=device, params=params)
        return pvc

    monkeypatch.setattr(infer_v2, "VoiceConverterV2", build)
    save_wav(str(tmp_path / "src.wav"), _audio(100, 150.0, 15), SR)
    save_wav(str(tmp_path / "ref.wav"), _audio(40, 220.0, 16), SR)
    out, stats = infer_v2.main(["--source", str(tmp_path / "src.wav"), "--target",
                         str(tmp_path / "ref.wav"), "--output", str(tmp_path / "out"),
                         "--diffusion-steps", "1", "--convert-style", "false",
                         "--device", "cpu"])
    wave, sr = load_wav(out)
    assert seen == {"device": "cpu", "params": None}
    assert sr == SR and len(wave) == 100 * HOP == stats["target_len"] * HOP
    assert np.isfinite(wave).all()


def test_ar_decode_microbench_is_registered():
    # every microbench component is ported since the v2 trainer (no WAITING list)
    assert {"ar_decode", "ar_decode_b4"} <= set(microbench.ALL)
    assert not hasattr(microbench, "WAITING")
