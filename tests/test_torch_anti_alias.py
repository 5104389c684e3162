"""Port K2 (seedvc_tpu_torch/ops/anti_alias.py) against the JAX package.

The port's plain twin (channels-first) is held to the JAX Pallas kernel
``anti_alias_snake`` run in interpret mode on the CPU, over the shape list of
tests/test_pallas_anti_alias.py, at that file's tolerance (atol 2e-5, rtol
1e-4: fp32 FIR sums in another order). The constants the wrapper hands the
CUDA kernel are held to the TPU kernel's, and the kernel's sin^2 scheme,
evaluated in numpy float32, to sin^2. The CUDA kernel is held to the twin in
tests/test_torch_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.dsp.filters import kaiser_sinc_filter1d as j_kaiser
from seedvc_tpu.nn.snake import SnakeAlias as JSnakeAlias
from seedvc_tpu.nn.snake import downsample2x as j_down
from seedvc_tpu.nn.snake import upsample2x as j_up
from seedvc_tpu.ops.pallas import anti_alias as j_aa
from seedvc_tpu.ops.pallas.anti_alias import anti_alias_snake as j_fused
from seedvc_tpu_torch.nn.snake import SnakeAlias, downsample2x, upsample2x
from seedvc_tpu_torch.ops import anti_alias as port
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_init

torch.set_num_threads(1)


def _inputs(seed, B, T, C, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    alpha = (rng.standard_normal(C) * scale).astype(np.float32)
    beta = (rng.standard_normal(C) * scale).astype(np.float32)
    return x, alpha, beta


def _cf(x: np.ndarray) -> torch.Tensor:
    """(B, T, C) numpy -> (B, C, T) contiguous tensor."""
    return torch.from_numpy(x).transpose(1, 2).contiguous()


@pytest.mark.parametrize("B,T,C", [(1, 512, 128), (2, 333, 24), (1, 40, 64),
                                   (1, 1500, 48), (1, 1024, 24), (2, 96, 96)])
def test_twin_matches_jax_kernel(B, T, C):
    x, alpha, beta = _inputs(0, B, T, C)
    ref = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                             tile_t=128))
    out = port.anti_alias_snake(_cf(x), torch.from_numpy(alpha), torch.from_numpy(beta))
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, atol=2e-5, rtol=1e-4)


def test_twin_nonlogscale():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 100, 32)).astype(np.float32)
    alpha = np.abs(rng.standard_normal(32)).astype(np.float32) + 0.5
    beta = np.abs(rng.standard_normal(32)).astype(np.float32) + 0.5
    ref = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                             logscale=False, tile_t=64))
    out = port.anti_alias_snake(_cf(x), torch.from_numpy(alpha), torch.from_numpy(beta),
                                logscale=False)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fn,jfn", [(upsample2x, j_up), (downsample2x, j_down)])
def test_resamplers_match_jax(fn, jfn):
    x = _inputs(2, 2, 77, 8)[0]
    ref = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_allclose(fn(_cf(x)).transpose(1, 2).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("snake_beta", [True, False])
def test_snake_alias_module_matches_jax(snake_beta):
    """SnakeAlias with trained-looking parameters carried across."""
    x = _inputs(3, 1, 200, 16)[0]
    jm = JSnakeAlias(16, snake_beta=snake_beta)
    params = jax_init(jm, jnp.asarray(x))
    rng = np.random.default_rng(4)
    params = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
              for k, v in params.items()}
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = load_jax_params(SnakeAlias(16, snake_beta=snake_beta), params)
    out = pm(_cf(x)).detach().transpose(1, 2).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_kernel_constants_match_tpu_kernel():
    """The 35 float32 constants of the CUDA kernel, against what
    ``_make_kernel_clean`` and ``_sin2`` use: up-FIR taps 2 f[k] and down-FIR
    taps f[k] of kaiser_sinc_filter1d(0.25, 0.3, 12), the sin^2 coefficients
    (``_COS_C`` with 1/2 - cos/2 and theta^2 = 4 z^2 folded in), 1/pi, and
    pi as the f32 pi plus its f32 remainder (Cody-Waite)."""
    f = j_kaiser(0.25, 0.3, 12).astype(np.float64)
    c = j_aa._COS_C
    sin2 = [0.5 - 0.5 * c[0]] + [-0.5 * c[k] * 4.0 ** k for k in range(1, 8)]
    pi_hi = np.float32(j_aa._PI)
    want = np.array([*(2.0 * f), *f, *sin2, j_aa._INV_PI, pi_hi,
                     j_aa._PI - np.float64(pi_hi)], np.float32)
    got = port.kernel_constants()
    assert got.dtype == np.float32 and got.shape == (35,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:12], np.float32(2.0) * j_kaiser(0.25, 0.3, 12))


def _fma32(a, b, c):
    """float32 fused multiply-add: the product of two float32 is exact in
    float64, so one rounding to float32 remains (barring rare double-rounding
    ties, far below the tolerance)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def kernel_sin2(y: np.ndarray) -> np.ndarray:
    """The CUDA kernel's sin^2(y), step for step in float32 (``snake`` in
    anti_alias.cu): n = round(y / pi) by the 1.5 * 2^23 constant, z = y - n pi
    with pi in two parts, Horner in z^2."""
    k = port.kernel_constants()
    sin2, inv_pi, pi_hi, pi_lo = k[24:32], k[32], k[33], k[34]
    rnd = np.float32(12582912.0)
    n = (_fma32(y, inv_pi, rnd) - rnd).astype(np.float32)
    z = _fma32(-n, pi_hi, y)
    z = _fma32(-n, pi_lo, z)
    t = (z * z).astype(np.float32)
    p = np.full_like(y, sin2[7])
    for i in range(6, -1, -1):
        p = _fma32(p, t, sin2[i])
    return p


@pytest.mark.parametrize("reference", ["sin", "tpu_sin2"])
def test_kernel_sin2_scheme(reference):
    """Within 1e-6 of sin(y)^2 (float64) over |y| <= 500, beyond the reach of
    |alpha * u| in chip_smoke.py's large-alpha case; the measured error is
    about 2e-7, where a single-constant pi would give 8e-6 at |y| = 300. And
    within 1e-6 of the TPU kernel's own ``_sin2`` (JAX, f32) over |y| <= 10:
    further out its single-constant reduction leaves f32 errors of its own
    (2.2e-5 against sin^2 at |y| = 300), which the kernel's two-constant pi
    avoids."""
    lim = 500.0 if reference == "sin" else 10.0
    y = np.linspace(-lim, lim, 2_000_001, dtype=np.float32)
    half_pi = np.float32(np.pi / 2) * np.arange(-320, 321, dtype=np.float32)
    y = np.concatenate([y, half_pi[np.abs(half_pi) <= lim]])
    if reference == "sin":
        ref = np.sin(y.astype(np.float64)) ** 2
    else:
        ref = np.asarray(j_aa._sin2(jnp.asarray(y)), np.float64)
    assert np.abs(kernel_sin2(y) - ref).max() <= 1e-6
