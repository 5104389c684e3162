"""The port's v2 modules against the JAX package's, tiny and f32, on the
same random weights (tests/torch_port_helpers.py::jax_init) and the same
seeded numpy inputs: GRN, the ConvNeXtV2 block and a stage with down- and
up-sampling, BSQ (indices and output) and ``duration_reduction``, the ASTRAL
quantizer, the discrete regulator (one codebook, and three with mixed
``n_quantizers``), ``DiTV2`` (with and without ``x_lens``, through
``static_cond``, K1's plain twin and the einsum path) and
``euler_solve_multicfg`` in its five CFG layouts. Limit: 1e-4 max abs;
indices equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.core.config import LengthRegulatorConfig as JRegCfg
from seedvc_tpu.models import astral as jastral
from seedvc_tpu.models import cfm_v2 as jcfm
from seedvc_tpu.models import dit_v2 as jdit
from seedvc_tpu.models.regulator import InterpolateRegulator as JReg
from seedvc_tpu.nn import bsq as jbsq
from seedvc_tpu.nn import convnext as jcnx
from seedvc_tpu_torch.core.config import LengthRegulatorConfig
from seedvc_tpu_torch.models import astral, cfm_v2, dit_v2
from seedvc_tpu_torch.models.regulator import InterpolateRegulator
from seedvc_tpu_torch.nn import bsq, convnext
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_apply, jax_init

torch.set_num_threads(1)
TOL = 1e-4


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _port(module, params):
    return load_jax_params(module, params).eval()


def _close(p, j, tol=TOL):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def _grn_params(params):
    """GRN's gamma/beta init to zero; give them values so they count."""
    for name in list(params):
        if name == "grn" or name.startswith("blocks_"):
            sub = params[name]["grn"] if name.startswith("blocks_") else params[name]
            sub["gamma"] = _x(11, *sub["gamma"].shape)
            sub["beta"] = _x(12, *sub["beta"].shape)
    return params


def test_grn_matches_jax():
    x = _x(0, 2, 9, 16)
    params = jax_init(jcnx.GRN(16), x)
    params["gamma"], params["beta"] = _x(1, 1, 1, 16), _x(2, 1, 1, 16)
    with torch.no_grad():
        _close(_port(convnext.GRN(16), params)(torch.from_numpy(x)),
               jax_apply(jcnx.GRN(16), params, x))


@pytest.mark.parametrize("dilation", [1, 2])
def test_convnext_block_matches_jax(dilation):
    x = _x(3, 2, 13, 16)
    jm = jcnx.ConvNeXtV2Block(16, 40, dilation)
    params = jax_init(jm, x, seed=4)
    params["grn"]["gamma"], params["grn"]["beta"] = _x(5, 1, 1, 40), _x(6, 1, 1, 40)
    with torch.no_grad():
        _close(_port(convnext.ConvNeXtV2Block(16, 40, dilation), params)(torch.from_numpy(x)),
               jax_apply(jm, params, x))


def test_convnext_stage_with_resampling_matches_jax():
    """Input/output projections, a 2x downsample before block 1 and a 2x
    upsample before block 2 (flax's ConvTranspose kernel lands flipped)."""
    kw = dict(dim=16, intermediate_dim=32, num_blocks=3, input_dim=12, output_dim=20,
              downsample_layer_indices=(1,), downsample_factors=(2,),
              upsample_layer_indices=(2,), upsample_factors=(2,))
    x = _x(7, 2, 14, 12)
    jm = jcnx.ConvNeXtV2Stage(**kw)
    params = _grn_params(jax_init(jm, x, seed=8))
    pm = _port(convnext.ConvNeXtV2Stage(**kw), params)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert out.shape == (2, 14, 20)
    _close(out, jax_apply(jm, params, x))


def test_bsq_indices_and_output_match_jax():
    x = _x(9, 3, 17, 24)
    jm = jbsq.BSQ(dim=24, codebook_size=32)
    params = jax_init(jm, x, seed=10)
    j_out, j_idx, _ = jax_apply(jm, params, x)
    pm = _port(bsq.BSQ(24, 32), params)
    with torch.no_grad():
        p_out, p_idx, aux = pm(torch.from_numpy(x))
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    assert p_idx.max() < 32 and len(np.unique(p_idx.numpy())) > 8
    _close(p_out, j_out)
    assert float(aux) == 0.0
    # training=True: the same output and indices (straight-through) and
    # JAX's aux loss (tests/test_torch_bsq_train.py holds its gradients)
    j_out, j_idx, j_aux = jax_apply(jm, params, x, training=True)
    with torch.no_grad():
        p_out, p_idx, aux = pm(torch.from_numpy(x), training=True)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    _close(p_out, j_out)
    _close(aux, j_aux)


@pytest.mark.parametrize("tokens", [[], [4], [1, 1, 2, 2, 2, 3, 1, 1], [5, 6, 7]])
def test_duration_reduction_matches_jax(tokens):
    p_out, p_n = bsq.duration_reduction(np.array(tokens, np.int64))
    j_out, j_n = jbsq.duration_reduction(np.array(tokens, np.int64))
    np.testing.assert_array_equal(p_out, j_out)
    assert p_n == j_n


def test_astral_quantizer_matches_jax():
    jcfg = jastral.AstralConfig(dim=24, intermediate_dim=48, num_blocks=2, input_dim=32,
                                codebook_size=64)
    x = _x(13, 2, 21, 32)
    jm = jastral.AstralQuantizer(jcfg)
    params = _grn_params_in(jax_init(jm, x, seed=14))
    j_q, j_idx, _ = jax_apply(jm, params, x)
    pm = _port(astral.AstralQuantizer(astral.AstralConfig(**dataclasses.asdict(jcfg))), params)
    with torch.no_grad():
        p_q, p_idx, _ = pm(torch.from_numpy(x))
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    _close(p_q, j_q)


def _grn_params_in(params):
    params["encoder"] = _grn_params(params["encoder"])
    return params


@pytest.mark.parametrize("n_codebooks,n_q", [(1, None), (3, None), (3, (1, 3, 2))],
                         ids=["one_codebook", "three_codebooks", "mixed_n_quantizers"])
def test_discrete_regulator_matches_jax(n_codebooks, n_q):
    """24 tokens regulated to 40 frames in a 64-frame buffer; the input is
    cropped at x_lens = 20."""
    kw = dict(channels=16, is_discrete=True, content_codebook_size=50,
              sampling_ratios=(1, 1), n_codebooks=n_codebooks)
    rng = np.random.default_rng(15)
    shape = (3, 24) if n_codebooks == 1 else (3, n_codebooks, 24)
    tok = rng.integers(0, 50, shape).astype(np.int32)
    ylens = np.array([40, 33, 40], np.int32)
    jm = JReg(JRegCfg(**kw))
    params = jax_init(jm, tok, ylens, 64, seed=16)
    nq = None if n_q is None else np.array(n_q, np.int32)
    j_out = jax.jit(lambda p, t, y, q: jm.apply({"params": p}, t, y, 64, n_quantizers=q,
                                                x_lens=jnp.asarray(20))[0])(
        params, tok, ylens, nq)
    pm = _port(InterpolateRegulator(LengthRegulatorConfig(**kw)), params)
    with torch.no_grad():
        p_out = pm(torch.from_numpy(tok).long(), torch.from_numpy(ylens), 64,
                   x_lens=torch.tensor(20),
                   n_quantizers=None if nq is None else torch.from_numpy(nq))[0]
    _close(p_out, j_out)


DIT = dict(hidden_dim=64, depth=2, num_heads=4, in_channels=20, content_dim=24,
           style_encoder_dim=12)


def _dit_pair(flash: bool):
    jcfg = jdit.DiTV2Config(**DIT, use_flash_attention=flash)
    jm = jdit.DiTV2(jcfg)
    T = 30
    z = jnp.zeros
    params = jax_init(jm, z((1, T, 20)), z((1, T, 20)), jnp.array([T]), z((1,)), z((1, 12)),
                      z((1, T, 24)), seed=17)
    pm = _port(dit_v2.DiTV2(dit_v2.DiTV2Config(**DIT, use_flash_attention=flash)), params)
    return jm, params, pm


def _dit_inputs(B=3, T=30):
    return (_x(18, B, T, 20), _x(19, B, T, 20), np.array([30, 21, 9], np.int32)[:B],
            np.random.default_rng(20).random(B).astype(np.float32), _x(21, B, 12),
            _x(22, B, T, 24))


@pytest.mark.parametrize("flash", [True, False], ids=["k1_twin", "einsum"])
@pytest.mark.parametrize("lens", [True, False], ids=["x_lens", "no_lens"])
def test_dit_v2_matches_jax(flash, lens):
    jm, params, pm = _dit_pair(flash)
    x, px, xl, t, style, cond = _dit_inputs()
    xl = xl if lens else None
    drop = np.array([0.0, 1.0, 0.0], np.float32)
    j = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, prompt_drop=drop,
                                       content_drop=drop[::-1].copy()))(
        params, x, px, xl, t, style, cond)
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        p = pm(T(x), T(px), T(xl), T(t), T(style), T(cond), prompt_drop=T(drop),
               content_drop=T(drop[::-1].copy()))
    _close(p, j)


def test_dit_v2_static_cond_matches_jax():
    """``return_static`` then ``static_cond`` equals one full call, on both
    sides."""
    jm, params, pm = _dit_pair(True)
    x, px, xl, t, style, cond = _dit_inputs()
    j_full = jax_apply(jm, params, x, px, xl, t, style, cond)
    static = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, return_static=True))(
        params, x, px, xl, t, style, cond)
    j_static = jax.jit(lambda p, s, *a: jm.apply({"params": p}, *a, static_cond=s))(
        params, static, x, px, xl, t, style, cond)
    args = [torch.from_numpy(a) for a in (x, px, xl, t, style, cond)]
    with torch.no_grad():
        sc = pm(*args, return_static=True)
        p_static = pm(*args, static_cond=sc)
    _close(p_static, j_full)
    _close(p_static, j_static)
    _close(sc["merged"], static["merged"])


# (cfg_rates, random_voice) of the five branch layouts; rates asymmetric
CFG_MODES = {"three_way": ((0.3, 0.9), False), "full_text": ((0.0, 0.9), False),
             "full_uncond": ((0.3, 0.0), False), "no_cfg": ((0.0, 0.0), False),
             "random_voice": ((0.3, 0.9), True)}


@pytest.mark.parametrize("mode", sorted(CFG_MODES))
def test_euler_solve_multicfg_matches_jax(mode):
    """A tiny DiTV2 as the estimator, 3 steps, prompt 8 of 30 frames, the
    same noise (JAX's normal from the key, times temperature 0.8) on both
    sides; the rates swapped must not pass where the swap changes the
    weights."""
    rates, rv = CFG_MODES[mode]
    jm, params, pm = _dit_pair(True)
    B, T, steps, p_len = 2, 30, 3, 8
    mu, prompt, style = _x(23, B, T, 24), _x(24, B, T, 20), _x(25, B, 12)
    xl = np.array([30, 24], np.int32)
    key = jax.random.PRNGKey(3)

    def j_solve(p, key):
        est = lambda x, px, l, t, s, m, sc=None: jm.apply(  # noqa: E731
            {"params": p}, x, px, l, t, s, m, static_cond=sc)
        pre = lambda x, px, l, s, m: jm.apply(  # noqa: E731
            {"params": p}, x, px, l, jnp.zeros((x.shape[0],)), s, m, return_static=True)
        return jcfm.euler_solve_multicfg(est, key, mu, xl, prompt, p_len, style, n_mels=20,
                                         n_timesteps=steps, temperature=0.8, cfg_rates=rates,
                                         random_voice=rv, precompute_fn=pre)

    j_out = np.asarray(jax.jit(j_solve)(params, key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, T, 20))))

    def p_solve(r):
        def pre(x, px, lens, s, m):
            return pm(x, px, lens, torch.zeros(x.shape[0]), s, m, return_static=True)

        est = lambda x, px, lens, t, s, m, sc=None: pm(x, px, lens, t, s, m, static_cond=sc)  # noqa: E731
        return cfm_v2.euler_solve_multicfg(
            est, noise, torch.from_numpy(mu), torch.from_numpy(xl), torch.from_numpy(prompt),
            p_len, torch.from_numpy(style), n_timesteps=steps, temperature=0.8, cfg_rates=r,
            random_voice=rv, precompute_fn=pre)

    out = p_solve(rates)
    _close(out, j_out)
    assert (out[:, :p_len] == 0).all()
    if mode in ("three_way", "full_uncond", "full_text"):
        swapped = p_solve(rates[::-1])
        assert np.abs(swapped.numpy() - j_out).max() > 100 * TOL


def test_cosine_t_span_matches_jax():
    np.testing.assert_allclose(cfm_v2.cosine_t_span(30).numpy(),
                               np.asarray(jcfm.cosine_t_span(30)), atol=1e-7)
