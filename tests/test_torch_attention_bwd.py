"""K1ᵇ's plain versions and the trainable attention against the JAX package.

The JAX package trains through ``dit_attention_fused_diff`` /
``dit_attention_diff``, custom_vjps whose bwd is ``jax.vjp`` of
``dit_attention_fused_reference`` / ``dit_attention_reference``. Here:

- the port's ``dit_attention_fused_bwd_reference`` / ``dit_attention_bwd_reference``
  (autograd through the twins) against that vjp: lens with a 0 entry (every
  key masked: dv is the mean of dO, dq and dk are 0), T = 77 and 128, f32,
  and bf16 q/k/v with an f32 upstream gradient (cast to q's dtype first, as
  the JAX bwd casts it);
- the JAX custom_vjp itself (its forward the Pallas kernel in interpret mode)
  at T = 128;
- the port's autograd Functions (``dit_attention_fused_diff``,
  ``dit_attention_diff``) on the CPU: the same gradients as the twins'
  autograd;
- ``Attention`` in grad mode against the JAX module's ``jax.grad``, on the
  K1 branch and on the K3 branch (grouped KV heads).

The CUDA kernel is held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).

Tolerances: f32 1e-5 times the largest gradient (summation order); bf16 2e-2
relative L2 (bf16 rounds at other places in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.nn.layers import Attention as JAttention
from seedvc_tpu.nn.layers import rope_cache as j_rope_cache
from seedvc_tpu.ops.pallas.attention import dit_attention_diff as j_plain_diff
from seedvc_tpu.ops.pallas.attention import dit_attention_fused_diff as j_fused_diff
from seedvc_tpu.ops.pallas.attention import dit_attention_fused_reference as j_fused_ref
from seedvc_tpu.ops.pallas.attention import dit_attention_reference as j_plain_ref
from seedvc_tpu_torch.nn.layers import Attention, rope_cache, rope_full_cache
from seedvc_tpu_torch.ops import attention as port
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import jax_init

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_REL = 2e-2


def _inputs(seed, B, H, T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, 64)).astype(np.float32) for _ in range(4)]


def _jax_vjp(rope, q, k, v, cos, sin, lens, g, dtype=jnp.float32):
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    lj = None if lens is None else jnp.asarray(lens, jnp.int32)
    cj, sj = jnp.asarray(cos), jnp.asarray(sin)

    def f(q_, k_, v_):
        return j_fused_ref(q_, k_, v_, cj, sj, lj) if rope else j_plain_ref(q_, k_, v_, lj)

    _, vjp = jax.vjp(f, j(q), j(k), j(v))
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g).astype(dtype))]


def _port_bwd(rope, q, k, v, cos, sin, lens, g, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    if rope:
        out = port.dit_attention_fused_bwd_reference(t(q), t(k), t(v), torch.from_numpy(cos),
                                                      torch.from_numpy(sin), lt,
                                                      torch.from_numpy(g))
    else:
        out = port.dit_attention_bwd_reference(t(q), t(k), t(v), lt, torch.from_numpy(g))
    assert all(x.dtype == dtype for x in out)
    return [x.float().numpy() for x in out]


def _close(got, ref, tol=F32_TOL):
    scale = max(float(np.abs(r).max()) for r in ref)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=f"d{name}")


CASES = [(77, None), (77, (0, 60)), (128, (128, 1)), (128, (0, 0)), (128, (97, 200))]


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("T,lens", CASES)
def test_twin_backward_matches_jax_vjp(rope, T, lens):
    q, k, v, g = _inputs(T, 2, 2, T)
    cos, sin = rope_full_cache(T, 64)
    got = _port_bwd(rope, q, k, v, cos, sin, lens, g)
    ref = _jax_vjp(rope, q, k, v, cos, sin, lens, g)
    _close(got, ref)
    if lens is not None and lens[0] == 0:
        # every key masked for sample 0: uniform P, so dv = mean of dO; no dq, dk
        np.testing.assert_allclose(got[2][0], np.broadcast_to(g[0].mean(axis=1, keepdims=True),
                                                              g[0].shape), atol=1e-6)
        assert not got[0][0].any() and not got[1][0].any()


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
def test_twin_backward_bf16_casts_g_like_jax(rope):
    q, k, v, g = _inputs(5, 2, 2, 96)
    cos, sin = rope_full_cache(96, 64)
    got = _port_bwd(rope, q, k, v, cos, sin, (90, 0), g, torch.bfloat16)
    ref = _jax_vjp(rope, q, k, v, cos, sin, (90, 0), g, jnp.bfloat16)
    for a, b in zip(got, ref):
        assert np.linalg.norm(a - b) <= BF16_REL * np.linalg.norm(b)


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
def test_jax_custom_vjp_is_what_the_port_computes(rope):
    """The JAX custom_vjp (Pallas forward in interpret mode, reference bwd)
    at T = 128 against the port's plain K1ᵇ."""
    q, k, v, g = _inputs(9, 1, 2, 128)
    cos, sin = rope_full_cache(128, 64)
    lens = jnp.asarray([100], jnp.int32)
    cj, sj = jnp.asarray(cos), jnp.asarray(sin)

    def f(q_, k_, v_):
        if rope:
            return j_fused_diff(q_, k_, v_, cj, sj, lens, block_q=128)
        return j_plain_diff(q_, k_, v_, lens, block_q=128)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    _close(_port_bwd(rope, q, k, v, cos, sin, (100,), g), ref)


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
def test_diff_functions_match_twin_autograd(rope):
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(11, 2, 2, 77))
    cos, sin = (torch.from_numpy(a) for a in rope_full_cache(77, 64))
    lens = torch.tensor([50, 0], dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if rope:
        out = port.dit_attention_fused_diff(*leaves, cos, sin, lens)
        ref = port.dit_attention_fused_reference(q, k, v, cos, sin, lens)
        twin = port.dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens, g)
    else:
        out = port.dit_attention_diff(*leaves, lens)
        ref = port.dit_attention_reference(q, k, v, lens)
        twin = port.dit_attention_bwd_reference(q, k, v, lens, g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out.backward(g)
    for leaf, t in zip(leaves, twin):
        torch.testing.assert_close(leaf.grad, t, rtol=0, atol=0)


@pytest.mark.parametrize("n_kv", [None, 1], ids=["k1", "k3"])
def test_attention_grad_matches_jax(n_kv):
    B, T, dim, H = 2, 77, 128, 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, dim)).astype(np.float32)
    w = rng.standard_normal((B, T, dim)).astype(np.float32)
    lens = np.array([70, 33], np.int32)
    jm = JAttention(dim, H, n_local_heads=n_kv, use_flash=True)
    freqs = jnp.asarray(j_rope_cache(T, 64))
    mask = jnp.asarray(np.arange(T)[None, :] < lens[:, None])[:, None, None, :]
    params = jax_init(jm, jnp.zeros((B, T, dim)), freqs, mask, seed=3)

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, freqs, mask) * w)

    j_gp, j_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    pm = load_jax_params(Attention(dim, H, n_local_heads=n_kv, use_flash=True), params)
    xt = torch.from_numpy(x).requires_grad_()
    rope_full = (None if n_kv else tuple(torch.from_numpy(a) for a in rope_full_cache(T, 64)))
    calls = []
    wrapped = port.dit_attention_fused_bwd if n_kv is None else port.dit_attention_bwd
    name = wrapped.__name__
    try:
        setattr(port, name, lambda *a: calls.append(1) or wrapped(*a))
        out = pm(xt, torch.from_numpy(rope_cache(T, 64)), torch.from_numpy(lens), rope_full)
        (out * torch.from_numpy(w)).sum().backward()
    finally:
        setattr(port, name, wrapped)
    assert calls == [1]  # the branch's Function ran its backward
    ref = jax.tree_util.tree_leaves(j_gp) + [np.asarray(j_gx)]
    got = (jax.tree_util.tree_leaves(to_jax_params(
        pm, {n: p.grad for n, p in pm.named_parameters()})) + [xt.grad.numpy()])
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=F32_TOL * scale)
