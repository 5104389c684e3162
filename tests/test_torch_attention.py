"""Port K1 and K3 (seedvc_tpu_torch/ops/attention.py) against the JAX package.

The port's plain twins are held to the JAX Pallas kernels
``dit_attention_fused`` (K1) and ``dit_attention`` (K3) run in interpret mode
on the CPU (same shapes and block_q as tests/test_pallas_attention.py); the
port's ``Attention`` module to the JAX one with the same weights, on each of
its three branches and with grouped KV heads. The CUDA kernels themselves are
held to the twins in tests/test_torch_cuda.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.nn.layers import Attention as JAttention
from seedvc_tpu.nn.layers import rope_cache as j_rope_cache
from seedvc_tpu.nn.layers import rope_full_cache as j_rope_full_cache
from seedvc_tpu.ops.pallas.attention import _pair_swap_matrix, _rope
from seedvc_tpu.ops.pallas.attention import dit_attention as j_plain
from seedvc_tpu.ops.pallas.attention import dit_attention_fused as j_fused
from seedvc_tpu.ops.pallas.attention import dit_attention_fused_reference as j_fused_ref
from seedvc_tpu.ops.pallas.attention import dit_attention_reference as j_plain_ref
from seedvc_tpu_torch.nn import layers
from seedvc_tpu_torch.nn.layers import Attention, apply_rope, rope_cache, rope_full_cache
from seedvc_tpu_torch.ops import attention as port
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_init

torch.set_num_threads(1)


def _inputs(seed, B, H, T, d, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("lens", [None, (200, 256)])
def test_twin_matches_jax_kernel_f32(lens):
    """f32: same math, different summation order -> 1e-5."""
    q, k, v = _inputs(3, 2, 4, 256, 64, np.float32)
    cos, sin = rope_full_cache(256, 64)
    lens_j = None if lens is None else jnp.asarray(lens)
    ref = j_fused(*(jnp.asarray(a) for a in (q, k, v, cos, sin)), lens_j, block_q=128)
    out = port.dit_attention_fused(*(torch.from_numpy(a) for a in (q, k, v, cos, sin)),
                                   None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_twin_matches_jax_kernel_bf16():
    """bf16: the TPU kernel rounds P to bf16 after a global max, the twin's
    softmax is fp32 then PV in fp32 -> the JAX file's bf16 tolerance 3e-2."""
    q, k, v = _inputs(4, 1, 2, 256, 64, np.float32)
    cos, sin = rope_full_cache(256, 64)
    ref = j_fused(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  jnp.asarray(cos), jnp.asarray(sin), jnp.array([250]), block_q=128)
    out = port.dit_attention_fused(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                   torch.from_numpy(cos), torch.from_numpy(sin),
                                   torch.tensor([250]))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2)


@pytest.mark.parametrize("lens", [None, (200, 256)])
def test_k3_twin_matches_jax_kernel_f32(lens):
    """K3 (post-RoPE inputs), f32: summation order only -> 1e-5."""
    q, k, v = _inputs(8, 2, 4, 256, 64, np.float32)
    lens_j = None if lens is None else jnp.asarray(lens)
    ref = j_plain(*(jnp.asarray(a) for a in (q, k, v)), lens_j, block_q=128)
    out = port.dit_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_k3_twin_matches_jax_kernel_bf16():
    """K3 in bf16: the TPU kernel rounds P to bf16, the twin keeps it fp32
    -> the JAX file's bf16 tolerance 3e-2."""
    q, k, v = _inputs(9, 1, 2, 256, 64, np.float32)
    ref = j_plain(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.array([250]),
                  block_q=128)
    out = port.dit_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                             torch.tensor([250]))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2)


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("lens", [(0, 200), (0, 0), (1, 256)])
def test_twins_match_jax_with_masked_rows(rope, lens):
    """lens with a 0 entry masks every key of that batch row: the JAX kernels
    (interpret mode) and the JAX references then give the mean of V over all
    T keys, which the CUDA core keeps by visiting every key tile when
    n_valid = 0 and skipping only tiles past ceil(n_valid / 64) otherwise.
    f32: summation order only -> 1e-5."""
    q, k, v = _inputs(11, 2, 2, 256, 64, np.float32)
    cos, sin = rope_full_cache(256, 64)
    lens_j = jnp.asarray(lens)
    if rope:
        jargs = tuple(jnp.asarray(a) for a in (q, k, v, cos, sin))
        refs = (j_fused(*jargs, lens_j, block_q=128), j_fused_ref(*jargs, lens_j))
        out = port.dit_attention_fused(*(torch.from_numpy(a) for a in (q, k, v, cos, sin)),
                                       torch.tensor(lens, dtype=torch.int32))
    else:
        jargs = tuple(jnp.asarray(a) for a in (q, k, v))
        refs = (j_plain(*jargs, lens_j, block_q=128), j_plain_ref(*jargs, lens_j))
        out = port.dit_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 torch.tensor(lens, dtype=torch.int32))
    for ref in refs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for b, n in enumerate(lens):
        if n == 0:
            np.testing.assert_allclose(out[b].numpy(), np.broadcast_to(
                v[b].mean(axis=1, keepdims=True), v[b].shape), atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rope_scaled_twin_matches_jax_rope(dtype):
    """K1's pre-pass twin against the TPU kernel's own RoPE: q is
    ``(_rope(q, cos, sin, swap) * scale).astype(dtype)`` and k
    ``_rope(k, cos, sin, swap).astype(dtype)``. Tolerance 0: both round each
    product and the sum in fp32 (the swap is a product with a 0/1 matrix,
    exact) and the power-of-two scale is exact, so the bits agree in f32 and
    after the bf16 cast."""
    T, d = 128, 64
    x = np.random.default_rng(12).standard_normal((T, d)).astype(np.float32)
    cos, sin = rope_full_cache(T, d)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    swap = _pair_swap_matrix(d)
    for scale in (0.125, 1.0):
        ref = _rope(xj, jnp.asarray(cos), jnp.asarray(sin), swap)
        ref = np.asarray(((ref * scale) if scale != 1.0 else ref).astype(jdt).astype(jnp.float32))
        out = port.rope_scaled_reference(xt, torch.from_numpy(cos), torch.from_numpy(sin),
                                         scale).float().numpy()
        np.testing.assert_array_equal(out, ref)


def test_rope_prepass_twin_on_cpu():
    """On the CPU the pre-pass entry is its twin: q roped times 2^-3, k
    roped, both in bf16, and K1's twin is attention on those."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(13, 1, 2, 64, 64, np.float32))
    cos, sin = (torch.from_numpy(a) for a in rope_full_cache(64, 64))
    qo, ko = port.rope_prepass(q, k, cos, sin)
    assert torch.equal(qo, port.rope_scaled_reference(q, cos, sin, 0.125))
    assert torch.equal(ko, port.rope_scaled_reference(k, cos, sin))
    assert torch.equal(qo.float() * 8, port.rope_scaled_reference(q, cos, sin).float())
    torch.testing.assert_close(port.dit_attention_fused(q, k, v, cos, sin),
                               port.dit_attention_reference(qo * 8, ko, v), atol=0, rtol=0)


def test_twin_ignores_padded_keys():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 256, 64, np.float32))
    cos, sin = (torch.from_numpy(a) for a in rope_full_cache(256, 64))
    lens = torch.tensor([128])
    out1 = port.dit_attention_fused(q, k, v, cos, sin, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 128:] = 99.0
    v2[:, :, 128:] = -99.0
    out2 = port.dit_attention_fused(q, k2, v2, cos, sin, lens)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


def test_rope_caches_match_jax():
    np.testing.assert_array_equal(rope_cache(100, 64), j_rope_cache(100, 64))
    for a, b in zip(rope_full_cache(100, 64), j_rope_full_cache(100, 64)):
        np.testing.assert_array_equal(a, b)


def test_apply_rope_equals_full_cache_form():
    """Interleaved-pair RoPE two ways: apply_rope and the kernel's cos /
    signed-sin form."""
    x = torch.from_numpy(_inputs(6, 1, 3, 50, 64, np.float32)[0])  # (B, H, T, d)
    freqs = torch.from_numpy(rope_cache(50, 64))
    a = apply_rope(x.transpose(1, 2), freqs).transpose(1, 2)
    cos, sin = (torch.from_numpy(c) for c in rope_full_cache(50, 64))
    b = x * cos + port._pair_swap(x) * sin
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def _module_case(dim, H, n_kv, flash, T, lens, seed=7):
    """(port module, JAX output, port inputs) for one Attention case."""
    B = 2
    x = np.random.default_rng(seed).standard_normal((B, T, dim)).astype(np.float32)
    jm = JAttention(dim, H, n_local_heads=n_kv, use_flash=flash)
    freqs = jnp.asarray(j_rope_cache(T, dim // H))
    mask = None
    if lens is not None:
        mask = (jnp.arange(T)[None, :] < jnp.asarray(lens)[:, None])[:, None, None, :]
    params = jax_init(jm, jnp.asarray(x), freqs, mask)
    ref = jm.apply({"params": params}, jnp.asarray(x), freqs, mask)
    pm = load_jax_params(Attention(dim, H, n_local_heads=n_kv, use_flash=flash), params)
    rope_full = None
    if flash and n_kv is None:  # the trunk builds it only then, as the JAX one does
        rope_full = tuple(torch.from_numpy(a) for a in rope_full_cache(T, dim // H))
    args = (torch.from_numpy(x), torch.from_numpy(rope_cache(T, dim // H)),
            None if lens is None else torch.tensor(lens, dtype=torch.int32), rope_full)
    return pm, np.asarray(ref), args


@pytest.mark.parametrize("lens", [None, "partial"])
@pytest.mark.parametrize("flash,n_kv", [(False, None), (True, None), (False, 2), (True, 2),
                                        (False, 1), (True, 1)])
def test_attention_module_matches_jax(flash, n_kv, lens):
    """Port Attention (twins on CPU) vs the JAX module's einsum path, same
    weights, f32 -> 1e-5. n_head 4 with 4, 2 or 1 KV heads, so the wqkv
    split and the repeat order of grouped heads are both held; with flash the
    port takes K1 (heads not grouped) or K3 (grouped) at T = 512."""
    T = 512 if flash else 64
    lens = None if lens is None else (T - T // 4, T)
    pm, ref, args = _module_case(256, 4, n_kv, flash, T, lens)
    out = pm(*args)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flash,n_kv,T,expect", [
    (True, None, 512, "k1"), (True, 2, 512, "k3"), (True, None, 320, "k1"),
    (True, 2, 320, "k3"), (False, None, 512, "einsum")])
def test_attention_branch_rule(monkeypatch, flash, n_kv, T, expect):
    """JAX's rule without its TPU check and without its Pallas tiling limit
    (T % 512 == 0; K1 and K3 mask keys >= T, so any T takes them): K1 with
    flash, heads not grouped and rope_full; K3 with flash otherwise; else
    einsum. Also K3 when rope_full is not given (the microbench's call). In
    grad mode the same branch runs through its autograd Function (K1ᵇ
    backward)."""
    calls = []
    for name, tag in (("dit_attention_fused", "k1"), ("dit_attention", "k3"),
                      ("dit_attention_fused_diff", "k1_diff"), ("dit_attention_diff", "k3_diff")):
        monkeypatch.setattr(layers, name, lambda *a, _f=getattr(port, name), _t=tag:
                            calls.append(_t) or _f(*a))
    pm, _, args = _module_case(128, 2, n_kv, flash, T, None)
    with torch.no_grad():
        pm(*args)
    assert calls == ([] if expect == "einsum" else [expect])
    calls.clear()
    pm(*args)
    assert calls == ([] if expect == "einsum" else [expect + "_diff"])
    if expect == "k1":
        calls.clear()
        with torch.no_grad():
            pm(*args[:3])
        assert calls == ["k3"]


@pytest.mark.parametrize("n_kv", [None, 2])
def test_attention_module_matches_jax_ragged_T(n_kv):
    """With flash at a T that is no multiple of 512 the port still takes K1
    (heads not grouped) or K3 (grouped), partial lens; against the JAX
    module's einsum path, f32 -> 1e-5."""
    pm, ref, args = _module_case(256, 4, n_kv, True, 333, (300, 333))
    out = pm(*args)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-5)
