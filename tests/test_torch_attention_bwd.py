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
  K1 branch and on the K3 branch (grouped KV heads);
- the row log-sum-exp the autograd Functions keep for K1ᵇ against jnp's;
  the exact gradients of a batch row with one valid key, which K1ᵇ writes
  as a case of its own; and a numpy emulation of K1ᵇ's 3xTF32 products
  against an f64 reference, within the card's f32 limit.

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
from seedvc_tpu.ops.pallas.attention import NEG_INF as j_neg_inf
from seedvc_tpu.ops.pallas.attention import _pair_swap as j_pair_swap
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


LSE_CASES = [None, (60, 77), (0, 50), (1, 77)]


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("lens", LSE_CASES, ids=["none", "partial", "zero", "one"])
def test_function_saves_the_plain_lse(rope, lens):
    """The autograd Function keeps the forward's row log-sum-exp for K1ᵇ; on
    the CPU it is the plain one, held here to jnp's logsumexp of the JAX
    twin's masked logits (RoPE through the same caches, -1e30 past lens;
    a row with no valid key gives -1e30): 1e-5 relative."""
    T = 77
    q, k, v, _ = _inputs(21, 2, 2, T)
    cos, sin = rope_full_cache(T, 64)
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if rope:
        out = port.dit_attention_fused_diff(*leaves, torch.from_numpy(cos),
                                            torch.from_numpy(sin), lt)
    else:
        out = port.dit_attention_diff(*leaves, lt)
    lse = out.grad_fn.saved_tensors[-1]
    assert lse.shape == (2, 2, T) and lse.dtype == torch.float32

    qj, kj = jnp.asarray(q), jnp.asarray(k)
    if rope:
        cj, sj = jnp.asarray(cos), jnp.asarray(sin)
        qj, kj = (x * cj + j_pair_swap(x) * sj for x in (qj, kj))
    s = jnp.einsum("bhqd,bhkd->bhqk", qj, kj) / 8.0
    if lens is not None:
        mask = jnp.arange(T)[None, :] < jnp.asarray(lens)[:, None]
        s = jnp.where(mask[:, None, None, :], s, j_neg_inf)
    ref = np.asarray(jax.nn.logsumexp(s, axis=-1))
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
def test_one_valid_key_gradients_are_exact_in_jax(rope):
    """K1ᵇ's one-valid-key case rests on this: with P = (1, 0, ...) JAX's vjp
    of the twin gives dq = dk = 0 exactly (P (g - Σ g P) is 0 where P is 1
    and 0 elsewhere; masked keys take no gradient through the where) and
    dv = Σ_q dO at key 0, 0 at the others (1e-6)."""
    q, k, v, g = _inputs(31, 2, 2, 96)
    cos, sin = rope_full_cache(96, 64)
    dq, dk, dv = _jax_vjp(rope, q, k, v, cos, sin, (1, 70), g)
    assert not dq[0].any() and not dk[0].any()
    np.testing.assert_allclose(dv[0, :, 0], g[0].sum(axis=1), rtol=0, atol=1e-6)
    assert not dv[0, :, 1:].any()
    assert dq[1].any() and dk[1].any()


def _tf32(x):
    """Round f32 to the nearest TF32 value (10-bit mantissa), ties away from
    zero: what cvt.rna.tf32.f32 gives."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b as K1ᵇ's tensor cores do it: each operand split into TF32 hi and
    lo = tf32(x - hi), lo.hi + hi.lo + hi.hi summed in f32 (products of TF32
    values are exact in f32)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("n_valid", [256, 200])
def test_3xtf32_backward_is_within_the_f32_limit(n_valid):
    """CPU evidence that K1ᵇ's f32 limit has room: the backward's five
    products in emulated 3xTF32, P from an f32 log-sum-exp and D from the f32
    output, at (1, 2, 256, 64), against an f64 reference: relative L2 and
    max abs (over the largest gradient) within the card's 2e-6 and 5e-6."""
    T = 256
    q, k, v, g = _inputs(41, 1, 2, T)
    q, k, v, g = (x[0] for x in (q, k, v, g))
    keep = np.arange(T) < n_valid
    got, ref = [], []
    for h in range(2):
        # f64 reference
        s = q[h].astype(np.float64) @ k[h].T.astype(np.float64) / 8.0
        s[:, ~keep] = -np.inf
        p = np.exp(s - s.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        o = p @ v[h]
        dp = g[h].astype(np.float64) @ v[h].T.astype(np.float64)
        ds = p * (dp - (dp * p).sum(axis=1, keepdims=True))
        ref.append((ds @ k[h] / 8.0, ds.T @ q[h] / 8.0, p.T @ g[h]))
        # the kernel's arithmetic: qs = q / 8 (exact), 3xTF32 products in f32
        qs = (q[h] / np.float32(8.0)).astype(np.float32)
        s32 = _mm_3xtf32(qs, k[h].T)
        lse = np.float32(np.log(np.exp(s32[:, keep].astype(np.float64)).sum(axis=1)))
        p32 = np.where(keep, np.exp(s32 - lse[:, None]), np.float32(0)).astype(np.float32)
        dsum = (g[h] * o.astype(np.float32)).sum(axis=1, dtype=np.float32)
        dp32 = _mm_3xtf32(g[h], v[h].T)
        ds32 = (p32 * (dp32 - dsum[:, None])).astype(np.float32)
        got.append((_mm_3xtf32(ds32, k[h]) * np.float32(0.125), _mm_3xtf32(ds32.T, qs),
                    _mm_3xtf32(p32.T, g[h])))
    for i, name in enumerate(("dq", "dk", "dv")):
        a = np.stack([x[i] for x in got]).astype(np.float64)
        b = np.stack([x[i] for x in ref])
        assert np.linalg.norm(a - b) <= 2e-6 * np.linalg.norm(b), name
        assert np.abs(a - b).max() <= 5e-6 * np.abs(b).max(), name
