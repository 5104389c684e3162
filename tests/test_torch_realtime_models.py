"""The real-time model set of the port (``xlsr_tiny``: SSL encoder, HiFT
vocoder, DiT with prefix tokens) and its DSP against the JAX package, the
same weights carried across by ``load_jax_params``, f32 on the CPU.

Tolerances: SSL encoder and HiFT 1e-4 (the same f32 math summed in another
order through several layers); ``istft`` and ``resample`` 1e-5 (an FFT
against the JAX package's matmul DFT, and one conv); ``sine_source`` with the
same draws 3e-6 over 256 samples, 5e-5 over 4096 (its cumulative phase is an
f32 sum in another order: see that test); the DiT 1e-5.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.core.config import get_preset as j_get_preset
from seedvc_tpu.dsp.mel import hann_window as j_hann_window
from seedvc_tpu.dsp.resample import resample as j_resample
from seedvc_tpu.dsp.stft import istft as j_istft
from seedvc_tpu.models.dit import DiT as JDiT
from seedvc_tpu.models.hifigan import HiFTConfig as JHiFTConfig
from seedvc_tpu.models.hifigan import HiFTGenerator as JHiFTGenerator
from seedvc_tpu.models.hifigan import sine_source as j_sine_source
from seedvc_tpu.models.ssl import SSLConfig as JSSLConfig
from seedvc_tpu.models.ssl import SSLEncoder as JSSLEncoder
from seedvc_tpu_torch.core import config as pc
from seedvc_tpu_torch.dsp.resample import resample, resample_kernel
from seedvc_tpu_torch.dsp.stft import istft
from seedvc_tpu_torch.models.dit import DiT
from seedvc_tpu_torch.models.hifigan import HiFTConfig, HiFTGenerator, sine_source
from seedvc_tpu_torch.models.ssl import HUBERT_LARGE_L18, XLSR_300M_L12, SSLConfig, SSLEncoder
from seedvc_tpu_torch.nn.transformer import Transformer, TransformerConfig
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_apply, jax_hift_draws, jax_init

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
HIFT = dict(base_channels=32)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ssl_presets_match_jax():
    import seedvc_tpu.models.ssl as jssl

    for name, port in (("XLSR_300M_L12", XLSR_300M_L12), ("HUBERT_LARGE_L18", HUBERT_LARGE_L18)):
        assert dataclasses.asdict(port) == dataclasses.asdict(getattr(jssl, name)), name


@pytest.mark.parametrize("final_norm", [False, True], ids=["xlsr_like", "final_norm"])
def test_ssl_encoder_matches_jax(final_norm):
    """Two layers at 64 wide (4 heads), 32 conv channels, the grouped
    positional conv at its real kernel (128) and groups (16); 1 s of audio
    with a zero-padded tail (normalised with the zeros, as JAX does)."""
    kw = dict(conv_dim=32, d_model=64, n_layers=2, n_heads=4, ffn_dim=128,
              apply_final_norm=final_norm)
    wave = _rand(0, 1, 16000, scale=0.1)
    wave[:, 12000:] = 0.0
    jm = JSSLEncoder(JSSLConfig(**kw))
    params = jax_init(jm, jnp.asarray(wave))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(wave)))
    pm = load_jax_params(SSLEncoder(SSLConfig(**kw)).eval(), params)
    out = pm(_t(wave)).detach().numpy()
    assert out.shape == ref.shape == (1, 16000 // 320 - 1, 64)
    np.testing.assert_allclose(out, ref, **TOL)


def test_istft_matches_jax():
    """HiFT's geometry (n_fft 16, hop 4, periodic Hann), B = 2, 65 frames."""
    re, im = _rand(1, 2, 65, 9), _rand(2, 2, 65, 9)
    win = j_hann_window(16)
    ref = np.asarray(j_istft(jnp.asarray(re), jnp.asarray(im), 16, 4, jnp.asarray(win)))
    out = istft(_t(re), _t(im), 16, 4, torch.hann_window(16)).numpy()
    assert out.shape == ref.shape == (2, 256)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,new,T", [(22050, 16000, 5632), (22050, 16000, 3001),
                                        (16000, 22050, 1000), (44100, 16000, 777)])
def test_resample_matches_jax(orig, new, T):
    """torchaudio semantics, ceil target length: 22050 -> 16000 turns a
    streaming block of 5632 samples into 4087."""
    wave = _rand(3, 2, T, scale=0.3)
    ref = np.asarray(j_resample(jnp.asarray(wave), orig, new))
    out = resample(_t(wave), orig, new, resample_kernel(orig, new, "cpu")).numpy()
    assert out.shape == ref.shape == (2, math.ceil(new * T / orig))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(resample(_t(wave[0]), orig, new).numpy(), ref[0],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,tol", [(256, 3e-6), (4096, 5e-5)])
def test_sine_source_matches_jax(T, tol):
    """A voiced glide and an unvoiced tail (below the 10 Hz threshold), with
    the JAX draws of PRNGKey(0) fed to the port: uv equal; the sines differ
    only through the cumulative phase, an f32 sum taken in another order.
    Over 256 samples the phase reaches 33 cycles, where one f32 ulp (3.8e-6)
    times 2 pi times the sine amplitude 0.1 is 2.4e-6 -> 3e-6. Over 4096
    samples XLA's CPU cumsum drifts up to 2.4e-5 cycles from the exact sum
    (torch's 7.6e-6) -> 5e-5."""
    cfg = JHiFTConfig()
    f0 = np.concatenate([np.linspace(90, 320, T - T // 4), np.full(T // 4, 5.0)])
    f0 = np.stack([f0, f0[::-1]]).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ref_s, ref_uv = (np.asarray(a) for a in j_sine_source(key, jnp.asarray(f0), cfg))
    phase, noise = jax_hift_draws((2, T, 9), key)
    out_s, out_uv = sine_source(phase, noise, _t(f0), HiFTConfig())
    np.testing.assert_array_equal(out_uv.numpy(), ref_uv)
    np.testing.assert_allclose(out_s.numpy(), ref_s, atol=tol, rtol=0)


def test_hift_generator_matches_jax():
    """Tiny HiFT (base 32 channels, every other field the preset's), 20 mel
    frames, the JAX draws of PRNGKey(0) fed to the port."""
    mel = _rand(4, 1, 20, 80, scale=0.5)
    jm = JHiFTGenerator(JHiFTConfig(**HIFT))
    key = jax.random.PRNGKey(0)
    params = jax_init(jm, jnp.asarray(mel), key)
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(mel), key))
    pm = load_jax_params(HiFTGenerator(HiFTConfig(**HIFT)).eval(), params)
    draws = jax_hift_draws((1, 20 * 256, 9), key)
    out = pm(_t(mel), draws).detach().numpy()
    assert out.shape == ref.shape == (1, 20 * 256)
    np.testing.assert_allclose(out, ref, **TOL)
    # the default draws: the same on every call
    d1, d2 = pm.default_draws(1, 20 * 256, "cpu"), pm.default_draws(1, 20 * 256, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(d1, d2))
    assert d1[0].shape == (1, 1, 9) and d1[1].shape == (1, 20 * 256, 9)
    a, b = pm(_t(mel), d1), pm(_t(mel), d2)
    assert torch.equal(a, b) and a.shape == (1, 20 * 256)


def _xlsr_cfgs(**dit):
    jmp = j_get_preset("xlsr_tiny").model_params
    pmp = pc.get_preset("xlsr_tiny").model_params
    jmp = dataclasses.replace(jmp, DiT=dataclasses.replace(jmp.DiT, **dit))
    pmp = dataclasses.replace(pmp, DiT=dataclasses.replace(pmp.DiT, **dit))
    return jmp, pmp


@pytest.mark.parametrize("cond_drop", [None, (0.0, 1.0)])
@pytest.mark.parametrize("tokens", [(True, True), (True, False), (False, True)],
                         ids=["time_style", "time", "style"])
def test_dit_prefix_tokens_match_jax(tokens, cond_drop):
    """xlsr_tiny's DiT (MLP head, U-ViT skips, flash attention on: the port
    runs K1's twin at T + prefix) at 128 wide, 2 heads, depth 3, with ragged
    x_lens, per-sample cond_drop; then return_static / static_cond."""
    time_tok, style_tok = tokens
    jmp, pmp = _xlsr_cfgs(hidden_dim=128, num_heads=2, depth=3, content_dim=128,
                          time_as_token=time_tok, style_as_token=style_tok)
    assert jmp.DiT.use_flash_attention
    T = 70
    x, prompt = _rand(5, 2, T, 80), _rand(6, 2, T, 80)
    prompt[:, 20:] = 0.0
    x_lens = np.array([T, T - 23], np.int32)
    t = np.array([0.3, 0.7], np.float32)
    style, cond = _rand(7, 2, 192), _rand(8, 2, T, 128)
    args = (x, prompt, x_lens, t, style, cond)
    jm = JDiT(jmp)
    params = jax_init(jm, *(jnp.asarray(a) for a in args))
    cd = None if cond_drop is None else np.asarray(cond_drop, np.float32)
    ref = np.asarray(jax_apply(jm, params, *(jnp.asarray(a) for a in args),
                               cond_drop=None if cd is None else jnp.asarray(cd)))
    pm = load_jax_params(DiT(pmp).eval(), params)
    targs = [_t(a) for a in args]
    out = pm(*targs, cond_drop=None if cd is None else _t(cd))
    assert out.shape == (2, T, 80)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-5)
    if cond_drop is None:
        jstatic = jax_apply(jm, params, *(jnp.asarray(a) for a in args), return_static=True)
        static = pm(*targs, return_static=True)
        assert set(static) == set(jstatic) == {"merged", "style_tok"}
        for k in static:
            if jstatic[k] is None:
                assert static[k] is None
            else:
                np.testing.assert_allclose(static[k].detach().numpy(), np.asarray(jstatic[k]),
                                           atol=1e-5, rtol=1e-5)
        hoisted = pm(*targs[:3], targs[3], targs[4], targs[5], static_cond=static)
        torch.testing.assert_close(hoisted, out, atol=1e-6, rtol=1e-6)


def test_time_as_token_trunk_has_no_adaptive_projection():
    """The JAX trunk with time_as_token owns no project_layer; the port's
    neither, so load_jax_params fills every parameter."""
    cfg = TransformerConfig(dim=64, n_layer=3, n_head=1, time_as_token=True,
                            uvit_skip_connection=True)
    names = [n for n, _ in Transformer(cfg).named_parameters()]
    assert names and not any("project_layer" in n for n in names)
