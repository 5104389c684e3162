"""Port models against the JAX package with the same weights carried across
(flax tree -> ``load_jax_params``), f32 on the CPU.

Tolerance 1e-4 (abs and rel) for every model: the same f32 math summed in
another order through several layers; the full-width DiT gets 2e-4 for its
512-wide sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.core.config import get_preset as j_get_preset
from seedvc_tpu.models.bigvgan import BigVGAN as JBigVGAN
from seedvc_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from seedvc_tpu.models.campplus import CAMPPlus as JCAMPPlus
from seedvc_tpu.models.cfm import CFM as JCFM
from seedvc_tpu.models.cfm import make_sampler
from seedvc_tpu.models.dit import DiT as JDiT
from seedvc_tpu.models.regulator import InterpolateRegulator as JRegulator
from seedvc_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig
from seedvc_tpu.models.whisper import _sinusoid_init
from seedvc_tpu.nn.transformer import Transformer as JTransformer
from seedvc_tpu.nn.transformer import TransformerConfig as JTransformerConfig
from seedvc_tpu_torch.core import config as pc
from seedvc_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from seedvc_tpu_torch.models.campplus import CAMPPlus
from seedvc_tpu_torch.models.cfm import CFM, euler_solve
from seedvc_tpu_torch.models.dit import DiT
from seedvc_tpu_torch.models.regulator import InterpolateRegulator
from seedvc_tpu_torch.models.whisper import WhisperEncoder, WhisperEncoderConfig, sinusoids
from seedvc_tpu_torch.nn.transformer import Transformer, TransformerConfig
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_apply, jax_init

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_whisper_encoder_matches_jax():
    kw = dict(d_model=48, n_layers=2, n_heads=4, ffn_dim=96)
    jm = JWhisperEncoder(JWhisperEncoderConfig(**kw))
    mel = _rand(0, 1, 3000, 80)
    params = jax_init(jm, jnp.asarray(mel))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(mel)))
    pm = load_jax_params(WhisperEncoder(WhisperEncoderConfig(**kw)).eval(), params)
    np.testing.assert_allclose(pm(_t(mel)).detach().numpy(), ref, **TOL)


def test_whisper_position_table_matches_jax_init():
    """The fixed sinusoid table; f32 arguments up to 1500 rad are rounded
    differently by the two frameworks (one ulp there is 1.2e-4) -> 5e-4."""
    ref = np.asarray(_sinusoid_init(jax.random.PRNGKey(0), (1500, 768)))
    np.testing.assert_allclose(sinusoids(1500, 768).numpy(), ref, atol=5e-4)


def test_campplus_ragged_lengths_match_jax():
    """Masked batch (true lengths 150 and 97): mean-sub, CAM context pooling
    and stats pooling restricted to valid frames."""
    jm = JCAMPPlus()
    fb = _rand(1, 2, 150, 80)
    lens = np.array([150, 97], np.int32)
    fb[1, 97:] = 0.0
    params = jax_init(jm, jnp.asarray(fb), jnp.asarray(lens))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(fb), jnp.asarray(lens)))
    pm = load_jax_params(CAMPPlus().eval(), params)
    out = pm(_t(fb), _t(lens).long()).detach().numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_regulator_ragged_matches_jax():
    """Ragged ylens in a 128-frame bucket, content cropped to its true
    length: GroupNorm stats over ylens.max() and floor nearest-interp."""
    jcfg = j_get_preset("whisper_small_wavenet").model_params.length_regulator
    jcfg = dataclasses.replace(jcfg, channels=32, in_channels=48, sampling_ratios=(1, 1))
    pcfg = dataclasses.replace(pc.get_preset("whisper_small_wavenet").model_params
                               .length_regulator, channels=32, in_channels=48,
                               sampling_ratios=(1, 1))
    x = _rand(3, 2, 40, 48)
    ylens = np.array([101, 73], np.int32)
    jm = JRegulator(jcfg)
    params = jax_init(jm, jnp.asarray(x), jnp.asarray(ylens), target_len=128,
                      x_lens=jnp.asarray(35))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(x), jnp.asarray(ylens),
                               target_len=128, x_lens=jnp.asarray(35))[0])
    pm = load_jax_params(InterpolateRegulator(pcfg), params)
    out = pm(_t(x), _t(ylens), 128, x_lens=torch.tensor(35))[0].detach().numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def _dit_cfgs(**dit):
    jmp = j_get_preset("whisper_small_wavenet").model_params
    pmp = pc.get_preset("whisper_small_wavenet").model_params
    wn = dit.pop("wavenet", None)
    jmp = dataclasses.replace(jmp, DiT=dataclasses.replace(jmp.DiT, **dit))
    pmp = dataclasses.replace(pmp, DiT=dataclasses.replace(pmp.DiT, **dit))
    if wn:
        jmp = dataclasses.replace(jmp, wavenet=dataclasses.replace(jmp.wavenet, **wn))
        pmp = dataclasses.replace(pmp, wavenet=dataclasses.replace(pmp.wavenet, **wn))
    return jmp, pmp


def _dit_inputs(T, content_dim, seed=4):
    x = _rand(seed, 2, T, 80)
    prompt = _rand(seed + 1, 2, T, 80)
    prompt[:, 30:] = 0.0
    x_lens = np.array([T, T - 31], np.int32)
    t = np.array([0.3, 0.7], np.float32)
    style = _rand(seed + 2, 2, 192)
    cond = _rand(seed + 3, 2, T, content_dim)
    return x, prompt, x_lens, t, style, cond


def _check_dit(jmp, pmp, T, tol, cond_drop=None):
    args = _dit_inputs(T, jmp.DiT.content_dim)
    jm = JDiT(jmp)
    jargs = [jnp.asarray(a) for a in args]
    params = jax_init(jm, *jargs)
    cd = None if cond_drop is None else np.asarray(cond_drop, np.float32)
    ref = np.asarray(jax_apply(jm, params, *jargs,
                               cond_drop=None if cd is None else jnp.asarray(cd)))
    pm = load_jax_params(DiT(pmp).eval(), params)
    targs = [_t(a) for a in args]
    out = pm(*targs, cond_drop=None if cd is None else _t(cd))
    np.testing.assert_allclose(out.detach().numpy(), ref, **tol)
    return pm, targs, out


@pytest.mark.parametrize("cond_drop", [None, (0.0, 1.0)])
def test_dit_wavenet_uvit_long_skip_matches_jax(cond_drop):
    """WaveNet head, U-ViT skips (depth 5: layers 0-1 emit, 3-4 receive),
    long skip, ragged x_lens, per-sample cond_drop; then the static_cond hoist
    reproduces the direct call."""
    jmp, pmp = _dit_cfgs(hidden_dim=64, num_heads=2, depth=5, content_dim=64,
                         wavenet=dict(hidden_dim=32, num_layers=3))
    pm, (x, prompt, x_lens, t, style, cond), out = _check_dit(
        jmp, pmp, 96, TOL, cond_drop)
    if cond_drop is None:
        static = pm(x, prompt, x_lens, torch.zeros(2), style, cond, return_static=True)
        hoisted = pm(x, prompt, x_lens, t, style, cond, static_cond=static)
        torch.testing.assert_close(hoisted, out, atol=1e-6, rtol=1e-6)


def test_dit_full_width_depth2_matches_jax():
    """whisper_small_wavenet widths (hidden 512, 8 heads, WaveNet 512x8),
    depth cut to 2, T = 128."""
    jmp, pmp = _dit_cfgs(depth=2)
    _check_dit(jmp, pmp, 128, dict(atol=2e-4, rtol=2e-4))


def test_bigvgan_small_matches_jax():
    kw = dict(upsample_initial_channel=64, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 3)))
    jm = JBigVGAN(JBigVGANConfig(**kw))
    mel = _rand(5, 1, 12, 80)
    params = jax_init(jm, jnp.asarray(mel))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(mel)))
    pm = load_jax_params(BigVGAN(BigVGANConfig(**kw)).eval(), params)
    out = pm(_t(mel)).detach().numpy()
    assert out.shape == (1, 12 * 256)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_gqa_transformer_matches_jax(flash):
    """Two-layer trunk with grouped KV heads (4 query heads, 2 KV heads),
    U-ViT skips, ragged key lengths, T = 512. With flash the port runs K3's
    twin (the JAX trunk builds no rope_full for GQA either), without it the
    einsum path; the JAX side runs its einsum path on the CPU."""
    T, dim = 512, 256
    kw = dict(dim=dim, n_layer=2, n_head=4, n_local_heads=2, head_dim=64,
              uvit_skip_connection=True, use_flash=flash)
    jm = JTransformer(JTransformerConfig(**kw))
    x, c = _rand(10, 2, T, dim), _rand(11, 2, 1, dim)
    lens = np.array([T, 300], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None])[:, None, None, :]
    params = jax_init(jm, jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask)))
    pm = load_jax_params(Transformer(TransformerConfig(**kw)), params)
    out = pm(_t(x), _t(c), _t(lens))
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)


def test_batched_cfg_sampler_matches_jax(monkeypatch):
    """The slice as a whole: the CFG Euler sampler at B = 3 over a tiny DiT
    with use_flash_attention on (the port runs K1's twin at context 512),
    ragged x_lens, the conditioning hoisted by precompute_fn, and the same
    initial noise given to both (the JAX side's jax.random.normal patched,
    as tests/test_cross_impl_pipeline.py does). f32, 3 steps -> 1e-4."""
    jmp, pmp = _dit_cfgs(hidden_dim=128, num_heads=2, depth=3, content_dim=64,
                         wavenet=dict(hidden_dim=32, num_layers=2))
    assert jmp.DiT.use_flash_attention and pmp.DiT.use_flash_attention
    B, T, prompt_len, steps = 3, 512, 100, 3
    noise = _rand(20, B, T, 80)
    mu = _rand(21, B, T, 64)
    prompt = _rand(22, B, T, 80)
    style = _rand(23, B, 192)
    x_lens = np.array([T, 450, 301], np.int32)
    params = jax_init(JDiT(jmp), *(jnp.asarray(a) for a in _dit_inputs(T, 64)))
    real_normal = jax.random.normal

    def fake_normal(key, shape=None, dtype=jnp.float32, *a, **kw):
        if shape == (B, T, 80):
            return jnp.asarray(noise).astype(dtype)
        return real_normal(key, shape, dtype, *a, **kw)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    sampler = make_sampler(JCFM(jmp), {"params": {"estimator": params}}, n_mels=80,
                           n_timesteps=steps, cfg_rate=0.7)
    ref = np.asarray(sampler(jax.random.PRNGKey(0), jnp.asarray(mu), jnp.asarray(x_lens),
                             jnp.asarray(prompt), prompt_len, jnp.asarray(style)))
    cfm = load_jax_params(CFM(pmp).eval(), {"estimator": params})
    out = euler_solve(cfm.estimate, _t(noise), _t(mu), _t(x_lens), _t(prompt), prompt_len,
                      _t(style), n_timesteps=steps, cfg_rate=0.7,
                      precompute_fn=cfm.precompute_cond)
    assert out.shape == (B, T, 80)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
