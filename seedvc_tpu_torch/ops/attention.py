"""DiT attention: the CUDA kernel's wrappers and their plain twins.

One kernel source, ``seedvc_tpu_torch/csrc/attention.cu``, with a
compile-time RoPE flag, replaces two TPU kernels:

- K1 :func:`dit_attention_fused` replaces
  ``seedvc_tpu/ops/pallas/attention.py::dit_attention_fused`` (body
  ``_attn_kernel_v2``): q/k arrive before RoPE and are roped in the kernel.
  Plain twin: :func:`dit_attention_fused_reference`.
- K3 :func:`dit_attention` replaces
  ``seedvc_tpu/ops/pallas/attention.py::dit_attention`` (body
  ``_attn_kernel``): q/k arrive roped. Plain twin:
  :func:`dit_attention_reference`.

- what bounds them on the H100: operations. 4·B·H·T²·d products against
  8·B·H·T·d bytes of bf16 q/k/v/o (17.2 GFLOP vs 8.4 MB at the main-path
  shape (2, 8, 2048, 64)).
- what the design does about it: the TPU kernels keep a head's whole K/V in
  VMEM, which does not fit in Hopper's 227 KB of shared memory at T = 2560, so
  the CUDA kernels stream 64-key tiles with an online softmax; nothing
  (T, T)-sized touches device memory. In bf16, K1 first ropes q (times 2⁻³)
  and k once per call into scratch (:func:`rope_prepass`, plain twin
  :func:`rope_scaled_reference`); then K1 and K3 share one warp-specialised
  core: in each block of 64 query rows a producer warp keeps K/V tiles
  flowing by TMA through a ring of shared-memory slots and a consumer
  warpgroup runs both products on ``wgmma``, skipping key tiles that hold
  only masked keys. The f32 path uses scalar FMAs.

K1ᵇ, the backward of both (``seedvc_tpu_torch/csrc/attention_bwd.cu``),
is the counterpart of the ``bwd`` of ``_fused_diff`` / ``_plain_diff``
(``seedvc_tpu/ops/pallas/attention.py:315-367``), which in the JAX package
is an XLA vjp of the jnp reference, not a Pallas kernel.
:func:`dit_attention_fused_bwd` / :func:`dit_attention_bwd` give dq, dk, dv
of the plain twins' math from q, k, v, the forward's output and its
upstream gradient; their plain versions are
:func:`dit_attention_fused_bwd_reference` / :func:`dit_attention_bwd_reference`
(``torch.autograd.grad`` through the twin). The autograd Functions
:class:`DitAttentionFusedFn` and :class:`DitAttentionFn`, called as
:func:`dit_attention_fused_diff` and :func:`dit_attention_diff` after the JAX
names, run K1 or K3 forward and K1ᵇ backward.

- what bounds K1ᵇ: operations, 10·B·H·T²·d (S, dP, dQ, dK, dV) against
  about 11·B·H·T·d elements moved.
- what its design does about it: the flash pattern in four launches (fp32
  copies of the roped, 2⁻³-scaled q and of k, v, dO with D = rowsum(dO∘o);
  dQ with the row statistics recomputed; dK/dV; RoPE's transpose and the
  cast back), fp32 scalar FMAs, nothing (T, T)-sized in device memory.
  ``wgmma`` and TMA are later work.

A CPU tensor goes to the plain twin; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts K1's calls, ``DIT_ATTENTION_LAUNCHES`` K3's,
``BWD_LAUNCHES`` K1ᵇ's (for either forward).
"""

from __future__ import annotations

import ctypes
import math

import torch

from seedvc_tpu_torch.ops.build import load_library

NEG_INF = -1e30
HEAD_DIM = 64
LAUNCHES = 0
DIT_ATTENTION_LAUNCHES = 0
BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dit_attention_fused_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dit_attention_fused_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dit_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dit_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rope_prepass_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "dit_attention_bwd": [_P] * 12 + [_I] * 5 + [_P],
}


def _kernel(name: str, source: str = "attention"):
    lib = load_library(source)
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _pair_swap(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (x1, x0, x3, x2, ...) on the last axis."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack((x2[..., 1], x2[..., 0]), dim=-1).reshape(x.shape)


def dit_attention_reference(q, k, v, lens=None):
    """Materialised-logits attention, fp32 softmax (post-RoPE inputs)."""
    T, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if lens is not None:
        mask = torch.arange(T, device=q.device)[None, :] < lens[:, None]
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def rope_scaled_reference(x, cos, sin, scale: float = 1.0):
    """Interleaved RoPE through the (T, d) cos / signed-sin caches in fp32,
    times ``scale``, rounded to x's dtype: the plain twin of K1's pre-pass
    (q with scale 2⁻³, k with 1)."""
    xf = x.float()
    return ((xf * cos + _pair_swap(xf) * sin) * scale).to(x.dtype)


def dit_attention_fused_reference(q, k, v, cos, sin, lens=None):
    """Plain twin of K1: :func:`rope_scaled_reference` on q and k, then
    :func:`dit_attention_reference` (which scales the logits by 1/√d)."""
    return dit_attention_reference(rope_scaled_reference(q, cos, sin),
                                   rope_scaled_reference(k, cos, sin), v, lens)


def _check(op: str, q, k, v, lens, extra=()):
    """Shapes, dtypes, devices, contiguity and alignment the kernel takes."""
    B, H, T, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{op}: head_dim must be {HEAD_DIM}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{op}: unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{op}: {name} does not match q")
    for name, t in extra:
        if t.shape != (T, d) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{op}: {name} must be ({T}, {d}) f32 on {q.device}")
    if lens is not None:
        if lens.shape != (B,) or lens.dtype != torch.int32 or lens.device != q.device:
            raise ValueError(f"{op}: lens must be ({B},) int32 on {q.device}")
        if not lens.is_contiguous():
            raise ValueError(f"{op}: lens must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte aligned")


def _launch(op: str, fn, q, pointers, lens, scratch=()) -> torch.Tensor:
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the C side sets attributes of the current device
        err = fn(*pointers, None if lens is None else lens.data_ptr(), out.data_ptr(),
                 *(t.data_ptr() for t in scratch), B, H, T,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed (error {err})")
    return out


def dit_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor,
                        lens: torch.Tensor | None = None) -> torch.Tensor:
    """K1. q/k/v: (B, H, T, 64) bf16 or f32, before RoPE; cos/sin: (T, 64)
    f32 from ``rope_full_cache``; lens: (B,) valid key counts or None.
    Returns (B, H, T, 64) in q's dtype."""
    if q.device.type == "cpu":
        return dit_attention_fused_reference(q, k, v, cos, sin, lens)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention_fused: unsupported device {q.device}")
    _check("dit_attention_fused", q, k, v, lens, (("cos", cos), ("sin", sin)))
    bf16 = q.dtype == torch.bfloat16
    fn = _kernel("dit_attention_fused_bf16" if bf16 else "dit_attention_fused_f32")
    # bf16: the pre-pass writes roped q and k here before the core reads them
    scratch = (torch.empty((2, *q.shape), dtype=q.dtype, device=q.device),) if bf16 else ()
    out = _launch("dit_attention_fused", fn, q,
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr()),
                  lens, scratch)
    global LAUNCHES
    LAUNCHES += 1
    return out


def dit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lens: torch.Tensor | None = None) -> torch.Tensor:
    """K3. q/k/v: (B, H, T, 64) bf16 or f32, q/k already roped; lens: (B,)
    valid key counts or None (every key valid). Returns (B, H, T, 64) in
    q's dtype."""
    if q.device.type == "cpu":
        return dit_attention_reference(q, k, v, lens)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention: unsupported device {q.device}")
    _check("dit_attention", q, k, v, lens)
    fn = _kernel("dit_attention_bf16" if q.dtype == torch.bfloat16 else "dit_attention_f32")
    out = _launch("dit_attention", fn, q, (q.data_ptr(), k.data_ptr(), v.data_ptr()), lens)
    global DIT_ATTENTION_LAUNCHES
    DIT_ATTENTION_LAUNCHES += 1
    return out


def rope_prepass(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's first stage on its own: (rope(q)·2⁻³, rope(k)) in bf16, the
    inputs of the attention core. q/k: (B, H, T, 64) bf16 before RoPE;
    cos/sin: (T, 64) f32. K1 runs this stage inside its own call; this entry
    lets a test hold it to :func:`rope_scaled_reference` bit for bit."""
    if q.device.type == "cpu":
        return (rope_scaled_reference(q, cos, sin, 1.0 / math.sqrt(HEAD_DIM)),
                rope_scaled_reference(k, cos, sin))
    if q.device.type != "cuda":
        raise ValueError(f"rope_prepass: unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"rope_prepass: bf16 only, got {q.dtype}")
    _check("rope_prepass", q, k, k, None, (("cos", cos), ("sin", sin)))
    B, H, T, _ = q.shape
    qo, ko = torch.empty((2, *q.shape), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel("rope_prepass_bf16")(
            q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), qo.data_ptr(),
            ko.data_ptr(), B * H, T, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_prepass: CUDA launch failed (error {err})")
    return qo, ko


# ---------------------------------------------------------------------------
# K1ᵇ: the backward of K1 and K3, and the autograd Functions around them.

def _twin_grads(twin, q, k, v, rest, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = twin(*leaves, *rest)
        return torch.autograd.grad(out, leaves, g.to(q.dtype))


def dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens, g):
    """Plain version of K1ᵇ for K1: (dq, dk, dv) of
    :func:`dit_attention_fused_reference` at q, k, v (before RoPE) for the
    upstream gradient g (cast to q's dtype, as the JAX bwd casts it)."""
    return _twin_grads(dit_attention_fused_reference, q, k, v, (cos, sin, lens), g)


def dit_attention_bwd_reference(q, k, v, lens, g):
    """Plain version of K1ᵇ for K3: (dq, dk, dv) of
    :func:`dit_attention_reference` for the upstream gradient g."""
    return _twin_grads(dit_attention_reference, q, k, v, (lens,), g)


def _bwd_scratch_floats(B: int, H: int, T: int) -> int:
    """fp32 scratch of one K1ᵇ call: q, k, v, dO, dq, dk, dv in fp32 and
    three row vectors (D, max, sum)."""
    return 7 * B * H * T * HEAD_DIM + 3 * B * H * T


def _bwd(op: str, q, k, v, cos, sin, lens, o, g):
    extra = () if cos is None else (("cos", cos), ("sin", sin))
    _check(op, q, k, v, lens, extra)
    g = g.to(q.dtype).contiguous()
    for name, t in (("o", o), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{op}: {name} does not match q")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte aligned")
    B, H, T, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty(_bwd_scratch_floats(B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the C side sets attributes of the current device
        err = _kernel("dit_attention_bwd", "attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            None if lens is None else lens.data_ptr(), o.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, H, T,
            int(q.dtype == torch.bfloat16), int(cos is not None),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed (error {err})")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


def dit_attention_fused_bwd(q, k, v, cos, sin, lens, o, g):
    """K1ᵇ for K1: (dq, dk, dv) in q's dtype. q/k/v (B, H, T, 64) before
    RoPE, cos/sin (T, 64) f32, lens (B,) int32 or None, o the forward's
    output, g its upstream gradient."""
    if q.device.type == "cpu":
        return dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens, g)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention_fused_bwd: unsupported device {q.device}")
    return _bwd("dit_attention_fused_bwd", q, k, v, cos, sin, lens, o, g)


def dit_attention_bwd(q, k, v, lens, o, g):
    """K1ᵇ for K3: (dq, dk, dv) in q's dtype; q/k already roped."""
    if q.device.type == "cpu":
        return dit_attention_bwd_reference(q, k, v, lens, g)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention_bwd: unsupported device {q.device}")
    return _bwd("dit_attention_bwd", q, k, v, None, None, lens, o, g)


class DitAttentionFusedFn(torch.autograd.Function):
    """K1 forward, K1ᵇ backward; no gradient to cos, sin or lens."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, lens):
        o = dit_attention_fused(q, k, v, cos, sin, lens)
        ctx.save_for_backward(q, k, v, cos, sin, lens, o)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, lens, o = ctx.saved_tensors
        dq, dk, dv = dit_attention_fused_bwd(q, k, v, cos, sin, lens, o, g)
        return dq, dk, dv, None, None, None


class DitAttentionFn(torch.autograd.Function):
    """K3 forward, K1ᵇ backward; no gradient to lens."""

    @staticmethod
    def forward(ctx, q, k, v, lens):
        o = dit_attention(q, k, v, lens)
        ctx.save_for_backward(q, k, v, lens, o)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lens, o = ctx.saved_tensors
        dq, dk, dv = dit_attention_bwd(q, k, v, lens, o, g)
        return dq, dk, dv, None


def dit_attention_fused_diff(q, k, v, cos, sin, lens=None):
    """``dit_attention_fused`` with K1ᵇ as its backward (trainable)."""
    return DitAttentionFusedFn.apply(q, k, v, cos, sin, lens)


def dit_attention_diff(q, k, v, lens=None):
    """``dit_attention`` with K1ᵇ as its backward (trainable)."""
    return DitAttentionFn.apply(q, k, v, lens)
