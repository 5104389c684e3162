"""The v2 AR's decode step as a chain of CUDA kernels: the wrappers and
their plain twins.

``seedvc_tpu_torch/csrc/ar_decode.cu`` replaces no Pallas kernel: the JAX
package leaves the decode step (``seedvc_tpu/models/ar.py::ARTransformer.
decode_step``) to XLA. The port's plain step launched about forty PyTorch
and cuBLAS kernels a layer and ran launch-paced inside its CUDA graph, its
M <= 3 products on cuBLAS tiles that left most SMs idle.

- what bounds it on the H100: bytes. A step reads each weight once (163 MB
  of bf16 at ``ARConfig()``, 49 us at 3.35 TB/s) and the K/V slots each row
  attends, and does two operations per weight and batch row.
- what the design does about it: five launches a layer and one for the
  head, each a GEMV over every SM with the elementwise work around it fused
  (RMSNorm, RoPE and the cache write, SwiGLU, the residual add), its
  weights loaded into registers before it waits for the kernel before it
  (programmatic dependent launch); attention reads only the valid slots,
  split over blocks, and combines the splits in a fixed order. The kernels
  read the modules' own parameters in place and the positions from device
  memory, so one CUDA graph capture serves every step.

A layer is :func:`attn_in`, :func:`attention`, :func:`attn_out`,
:func:`ffn_in`, :func:`ffn_out`; then :func:`head`. Each wrapper takes CUDA
tensors of one type (bf16 or f32) and raises on anything else; its
``*_reference`` twin takes the same arguments and writes the same outputs
in plain PyTorch. Rounding follows the plain step (``models/ar.py``): q, k,
v, the attention output, each product's output and the FFN's hidden state in
the weights' type; logits and softmax f32, and the head's logits f32.
``LAUNCHES`` counts the kernels launched and ``KERNEL_LAUNCHES`` each
wrapper's (a CUDA graph's capture counts what one replay launches).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from seedvc_tpu_torch.ops.build import load_library

KERNELS = ("attn_in", "attention", "attn_out", "ffn_in", "ffn_out", "head")
LAUNCHES = 0
KERNEL_LAUNCHES = dict.fromkeys(KERNELS, 0)
HEAD_DIM = 64
GROUP = 6  # query heads a KV head the attention kernel takes (ARConfig(): 12 over 2)
RUN = 128  # keys of one attention block (a run)
MAX_RUNS = 64  # runs a (row, KV head): caches up to 8,192 slots
RECORD = GROUP * (HEAD_DIM + 2)  # floats of one run's partial output and statistics
_DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ar_attn_in": [_I] + [_P] * 5 + [_I] + [_P] * 4 + [_I] * 5 + [_F, _P],
    "ar_attention": [_I] + [_P] * 5 + [_I] + [_P] * 3 + [_I] * 4 + [_P],
    "ar_residual": [_I] + [_P] * 4 + [_I] * 3 + [_P],
    "ar_ffn_in": [_I] + [_P] * 5 + [_I] * 3 + [_F, _P],
    "ar_head": [_I] + [_P] * 4 + [_I] * 3 + [_F, _P],
}


@dataclass
class Scratch:
    """What the chain writes between its kernels, for B rows: q (B, H, hd),
    the attention output (B, H hd), the FFN's hidden state (B, I), the
    residual stream x (B, D), the attention's per-run records (B, G,
    MAX_RUNS, RECORD) f32 and counters (B, G) int32 (zero between calls), and
    the logits (B, V) f32."""

    q: torch.Tensor
    attn: torch.Tensor
    hidden: torch.Tensor
    x: torch.Tensor
    part: torch.Tensor
    counters: torch.Tensor
    logits: torch.Tensor


def new_scratch(B: int, cfg, device, dtype) -> Scratch:
    """The chain's buffers for B rows of an ``ARConfig``-shaped ``cfg``."""
    H, G, hd = cfg.n_head, cfg.n_local_heads, cfg.head_dim

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)
    return Scratch(q=empty(B, H, hd), attn=empty(B, H * hd),
                   hidden=empty(B, cfg.intermediate_size), x=empty(B, cfg.dim),
                   part=empty(B, G, MAX_RUNS, RECORD, dt=torch.float32),
                   counters=torch.zeros((B, G), dtype=torch.int32, device=device),
                   logits=empty(B, cfg.vocab_size, dt=torch.float32))


# --- argument checks --------------------------------------------------------

def _need(name: str, what: str, t: torch.Tensor, shape: tuple, dtype,
          contiguous: bool = True) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, needs {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {what} is {t.dtype}, needs {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _positions(name: str, what: str, t: torch.Tensor, shape: tuple) -> None:
    """An int64 position tensor, read at its stride."""
    _need(name, what, t, shape, torch.int64, contiguous=False)


def _on_card(name: str, tensors: tuple, positions: tuple = ()) -> None:
    """Every tensor on one CUDA device; the data (not the positions, read
    one element at a time) 16-byte aligned for the kernels' vector loads."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel runs on CUDA tensors only "
                         f"(the plain twin is {name}_reference)")
    for t in (*tensors, *positions):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor is not 16-byte aligned")


def _dtype(name: str, x: torch.Tensor):
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: {x.dtype}; the kernels take bf16 or f32")
    return x.dtype


_ENTRIES: dict = {}


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in KERNELS:
        KERNEL_LAUNCHES[name] = 0


def _launch(entry: str, kernel: str, device, *args) -> None:
    fn = _ENTRIES.get(entry)
    if fn is None:
        fn = getattr(load_library("ar_decode"), entry)
        fn.argtypes, fn.restype = _SIGNATURES[entry], ctypes.c_int
        _ENTRIES[entry] = fn
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed (error {err})")
    global LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES[kernel] += 1


# --- (a) attention input ----------------------------------------------------

def _check_attn_in(name, x, norm_w, wqkv, rope, input_pos, kv_pos, q, k_cache, v_cache):
    dt = _dtype(name, x)
    B, D = x.shape
    _, H, hd = q.shape
    _, G, S, _ = k_cache.shape
    for what, t, shape in (("x", x, (B, D)), ("norm_w", norm_w, (D,)),
                           ("wqkv", wqkv, ((H + 2 * G) * hd, D)), ("q", q, (B, H, hd)),
                           ("k_cache", k_cache, (B, G, S, hd)),
                           ("v_cache", v_cache, (B, G, S, hd))):
        _need(name, what, t, shape, dt)
    _need(name, "rope", rope, (S, hd // 2, 2), torch.float32)
    _positions(name, "input_pos", input_pos, (B,))
    _positions(name, "kv_pos", kv_pos, ())
    return B, D, H, G, S


def attn_in(x, norm_w, wqkv, rope, input_pos, kv_pos, q, k_cache, v_cache, eps: float) -> None:
    """RMSNorm(x) @ wqkv^T; RoPE of q and k at ``input_pos`` (clamped to the
    table ``rope`` (S, hd/2, 2), ``rope_cache``'s cos/sin); q into ``q`` (B, H,
    hd), k and v into slot min(kv_pos, S - 1) of the layer's caches (B, G, S,
    hd). x (B, D)."""
    name = "ar_decode.attn_in"
    B, D, H, G, S = _check_attn_in(name, x, norm_w, wqkv, rope, input_pos, kv_pos, q,
                                   k_cache, v_cache)
    if q.shape[2] != HEAD_DIM:
        raise ValueError(f"{name}: head size {q.shape[2]}, the kernel takes {HEAD_DIM}")
    _on_card(name, (x, norm_w, wqkv, rope, q, k_cache, v_cache), (input_pos, kv_pos))
    _launch("ar_attn_in", "attn_in", x.device, int(x.dtype == torch.bfloat16), x.data_ptr(),
            norm_w.data_ptr(), wqkv.data_ptr(), rope.data_ptr(), input_pos.data_ptr(),
            input_pos.stride(0), kv_pos.data_ptr(), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), B, D, H, G, S, eps)


def _rms_norm(x, w, eps):
    """nn/layers.py's RMSNorm: f32 statistics, the normed x rounded back,
    then scaled in x's type."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype) * w


def _slot(kv_pos, S):
    return torch.clamp(kv_pos, max=S - 1).reshape(1)


def attn_in_reference(x, norm_w, wqkv, rope, input_pos, kv_pos, q, k_cache, v_cache,
                      eps: float) -> None:
    B, D, H, G, S = _check_attn_in("ar_decode.attn_in_reference", x, norm_w, wqkv, rope,
                                   input_pos, kv_pos, q, k_cache, v_cache)
    hd = q.shape[2]
    qkv = F.linear(_rms_norm(x, norm_w, eps), wqkv)
    qk, v = qkv.split([(H + G) * hd, G * hd], dim=-1)
    cs = rope[torch.clamp(input_pos, 0, S - 1)][:, None]  # (B, 1, hd/2, 2)
    c, s = cs[..., 0], cs[..., 1]
    pairs = qk.reshape(B, H + G, hd // 2, 2).float()
    x0, x1 = pairs[..., 0], pairs[..., 1]
    qk = torch.stack([x0 * c + x1 * -s, x1 * c + x0 * s], dim=-1).reshape(B, H + G, hd)
    qk = qk.to(x.dtype)
    q.copy_(qk[:, :H])
    slot = _slot(kv_pos, S)
    k_cache.index_copy_(2, slot, qk[:, H:, None])
    v_cache.index_copy_(2, slot, v.reshape(B, G, 1, hd))


# --- (b) attention ------------------------------------------------------------

def _check_attention(name, q, k_cache, v_cache, kv_pos, min_key, out, part, counters):
    dt = _dtype(name, q)
    B, H, hd = q.shape
    _, G, S, _ = k_cache.shape
    for what, t, shape in (("q", q, (B, H, hd)), ("k_cache", k_cache, (B, G, S, hd)),
                           ("v_cache", v_cache, (B, G, S, hd)), ("out", out, (B, H * hd))):
        _need(name, what, t, shape, dt)
    if H != G * GROUP:
        raise ValueError(f"{name}: {H} query heads over {G} KV heads (the kernel takes "
                         f"{GROUP} a KV head)")
    if S > MAX_RUNS * RUN:
        raise ValueError(f"{name}: {S} cache slots, the kernel takes up to {MAX_RUNS * RUN}")
    _need(name, "part", part, (B, G, MAX_RUNS, RECORD), torch.float32)
    _need(name, "counters", counters, (B, G), torch.int32)
    _positions(name, "kv_pos", kv_pos, ())
    if min_key is not None:
        _positions(name, "min_key", min_key, (B,))
    return B, H, G, S


def attention(q, k_cache, v_cache, kv_pos, min_key, out, part, counters) -> None:
    """Single-query grouped attention: q (B, H, hd) roped; each row attends
    its KV head's slots [min_key[b], min(kv_pos, S - 1)] (from slot 0 when
    ``min_key`` is None; at least one slot) with f32 logits and softmax; the
    output, rounded to q's type, into ``out`` (B, H hd). The kernel runs a
    block for each ``RUN`` valid keys of a (row, KV head); ``part`` and
    ``counters`` are its scratch (:class:`Scratch`)."""
    name = "ar_decode.attention"
    B, H, G, S = _check_attention(name, q, k_cache, v_cache, kv_pos, min_key, out, part,
                                  counters)
    if q.shape[2] != HEAD_DIM:
        raise ValueError(f"{name}: head size {q.shape[2]}, the kernel takes {HEAD_DIM}")
    _on_card(name, (q, k_cache, v_cache, out, part, counters),
             (kv_pos,) if min_key is None else (kv_pos, min_key))
    _launch("ar_attention", "attention", q.device, int(q.dtype == torch.bfloat16), q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), kv_pos.data_ptr(),
            None if min_key is None else min_key.data_ptr(),
            0 if min_key is None else min_key.stride(0), part.data_ptr(), counters.data_ptr(),
            out.data_ptr(), B, H, G, S)


def attention_reference(q, k_cache, v_cache, kv_pos, min_key, out, part=None,
                        counters=None) -> None:
    """The same, reading no slot outside the valid range (``part`` and
    ``counters`` unused)."""
    B, H, hd = q.shape
    G, S = k_cache.shape[1], k_cache.shape[2]
    keys = torch.arange(S, device=q.device)[None, :]
    valid = keys <= kv_pos
    if min_key is not None:
        valid = valid & (keys >= min_key[:, None])
    valid = valid[:, None, :, None]  # (B, 1, S, 1)
    k = torch.where(valid, k_cache.float(), 0.0)
    v = torch.where(valid, v_cache.float(), 0.0)
    logits = torch.einsum("bgrd,bgsd->bgrs", q.float().reshape(B, G, H // G, hd), k)
    logits = (logits * hd ** -0.5).masked_fill(~valid[..., 0][:, :, None], -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out.copy_(torch.einsum("bgrs,bgsd->bgrd", probs, v).reshape(B, H * hd))


# --- (c), (e) a product plus the residual -------------------------------------

def _check_residual(name, a, w, x_in, x_out):
    dt = _dtype(name, a)
    B, K = a.shape
    D = w.shape[0]
    for what, t, shape in (("input", a, (B, K)), ("weight", w, (D, K)),
                           ("residual", x_in, (B, D)), ("output", x_out, (B, D))):
        _need(name, what, t, shape, dt)
    return B, K, D


def _residual(kernel, a, w, x_in, x_out) -> None:
    name = f"ar_decode.{kernel}"
    B, K, D = _check_residual(name, a, w, x_in, x_out)
    _on_card(name, (a, w, x_in, x_out))
    _launch("ar_residual", kernel, a.device, int(a.dtype == torch.bfloat16), a.data_ptr(),
            w.data_ptr(), x_in.data_ptr(), x_out.data_ptr(), B, K, D)


def _residual_reference(name, a, w, x_in, x_out) -> None:
    _check_residual(name, a, w, x_in, x_out)
    x_out.copy_(x_in + F.linear(a, w))


def attn_out(attn, wo, x_in, x_out) -> None:
    """x_out = x_in + attn @ wo^T (x_out may be x_in). attn (B, H hd)."""
    _residual("attn_out", attn, wo, x_in, x_out)


def attn_out_reference(attn, wo, x_in, x_out) -> None:
    _residual_reference("ar_decode.attn_out_reference", attn, wo, x_in, x_out)


def ffn_out(hidden, w2, x) -> None:
    """x += hidden @ w2^T, in place. hidden (B, I), x (B, D)."""
    _residual("ffn_out", hidden, w2, x, x)


def ffn_out_reference(hidden, w2, x) -> None:
    _residual_reference("ar_decode.ffn_out_reference", hidden, w2, x, x)


# --- (d) FFN input ---------------------------------------------------------------

def _check_ffn_in(name, x, norm_w, w1, w3, hidden):
    dt = _dtype(name, x)
    B, D = x.shape
    I = w1.shape[0]
    for what, t, shape in (("x", x, (B, D)), ("norm_w", norm_w, (D,)), ("w1", w1, (I, D)),
                           ("w3", w3, (I, D)), ("hidden", hidden, (B, I))):
        _need(name, what, t, shape, dt)
    return B, D, I


def ffn_in(x, norm_w, w1, w3, hidden, eps: float) -> None:
    """hidden = silu(h @ w1^T) * (h @ w3^T), h = RMSNorm(x). x (B, D)."""
    name = "ar_decode.ffn_in"
    B, D, I = _check_ffn_in(name, x, norm_w, w1, w3, hidden)
    _on_card(name, (x, norm_w, w1, w3, hidden))
    _launch("ar_ffn_in", "ffn_in", x.device, int(x.dtype == torch.bfloat16), x.data_ptr(),
            norm_w.data_ptr(), w1.data_ptr(), w3.data_ptr(), hidden.data_ptr(), B, D, I, eps)


def ffn_in_reference(x, norm_w, w1, w3, hidden, eps: float) -> None:
    _check_ffn_in("ar_decode.ffn_in_reference", x, norm_w, w1, w3, hidden)
    h = _rms_norm(x, norm_w, eps)
    hidden.copy_(F.silu(F.linear(h, w1)) * F.linear(h, w3))


# --- the head ------------------------------------------------------------------

def _check_head(name, x, norm_w, w, logits):
    dt = _dtype(name, x)
    B, D = x.shape
    V = w.shape[0]
    for what, t, shape in (("x", x, (B, D)), ("norm_w", norm_w, (D,)), ("w", w, (V, D))):
        _need(name, what, t, shape, dt)
    _need(name, "logits", logits, (B, V), torch.float32)
    return B, D, V


def head(x, norm_w, w, logits, eps: float) -> None:
    """logits = RMSNorm(x) @ w^T, f32, into ``logits`` (B, V)."""
    name = "ar_decode.head"
    B, D, V = _check_head(name, x, norm_w, w, logits)
    _on_card(name, (x, norm_w, w, logits))
    _launch("ar_head", "head", x.device, int(x.dtype == torch.bfloat16), x.data_ptr(),
            norm_w.data_ptr(), w.data_ptr(), logits.data_ptr(), B, D, V, eps)


def head_reference(x, norm_w, w, logits, eps: float) -> None:
    _check_head("ar_decode.head_reference", x, norm_w, w, logits)
    logits.copy_(F.linear(_rms_norm(x, norm_w, eps).float(), w.float()))
