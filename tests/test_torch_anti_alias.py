"""Port K2 (seedvc_tpu_torch/ops/anti_alias.py) against the JAX package.

The port's plain twin (channels-first) is held to the JAX Pallas kernel
``anti_alias_snake`` run in interpret mode on the CPU, over the shape list of
tests/test_pallas_anti_alias.py, at that file's tolerance (atol 2e-5, rtol
1e-4: fp32 FIR sums in another order). The CUDA kernel is held to the twin in
tests/test_torch_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.nn.snake import SnakeAlias as JSnakeAlias
from seedvc_tpu.nn.snake import downsample2x as j_down
from seedvc_tpu.nn.snake import upsample2x as j_up
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
