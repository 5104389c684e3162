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
  only masked keys. In f32 (the fine-tuning path) each product is three
  TF32 tensor-core products (3xTF32: f32-grade, bounded by 3× the
  operations at the 495 TFLOP/s TF32 peak): K1 ropes q (times 2⁻³) and k
  once per call in f32, then one core (``csrc/attention_tf32.cuh``) streams
  64-key tiles through a ``cp.async`` ring into ``mma.sync`` products. It
  can also write the row log-sum-exp (``return_lse``, plain version
  :func:`dit_attention_lse_reference`), which the autograd Functions keep
  for K1ᵇ.

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
  about 11·B·H·T·d elements moved; in f32 3× that at the TF32 peak.
- what its design does about it: the flash backward's five products on
  3xTF32 tensor cores (``mma.sync``), nothing (T, T)-sized in device
  memory: f32 copies of the roped, 2⁻³-scaled q and of k with
  D = rowsum(dO∘o); the row statistics from the forward's log-sum-exp
  (``lse=``), or computed by the forward core when it is not given; one
  kernel for dK/dV that adds dQ to an f32 accumulator by atomics (dQ's
  last bits vary from run to run); RoPE's transpose and the cast back. A
  batch row with at most one valid key is exact as its own case.

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
    "dit_attention_fused_f32": [_P] * 9 + [_I] * 3 + [_P],
    "dit_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dit_attention_f32": [_P] * 6 + [_I] * 3 + [_P],
    "rope_prepass_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "dit_attention_bwd": [_P] * 13 + [_I] * 5 + [_P],
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


def _masked_logits(q, k, lens):
    T, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if lens is not None:
        mask = torch.arange(T, device=q.device)[None, :] < lens[:, None]
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s


def dit_attention_reference(q, k, v, lens=None):
    """Materialised-logits attention, fp32 softmax (post-RoPE inputs)."""
    p = torch.softmax(_masked_logits(q, k, lens), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def dit_attention_lse_reference(q, k, lens=None):
    """Row log-sum-exp (B, H, T) f32 of :func:`dit_attention_reference`'s
    masked logits (post-RoPE q, k): the statistics the f32 kernel writes for
    K1ᵇ (-1e30 where a batch row has no valid key)."""
    return torch.logsumexp(_masked_logits(q, k, lens), dim=-1)


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(op: str, fn, q, pointers, lens, after_out=()) -> torch.Tensor:
    """Calls a C entry point (pointers..., lens, out, after_out..., B, H, T,
    stream) and returns out."""
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the C side sets attributes of the current device
        err = fn(*pointers, _ptr(lens), out.data_ptr(), *(_ptr(t) for t in after_out), B, H, T,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed (error {err})")
    return out


def _lse_buffer(q, want: bool):
    """The (B, H, T) f32 buffer the f32 kernel writes the row log-sum-exp to."""
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if want else None


def dit_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor,
                        lens: torch.Tensor | None = None, return_lse: bool = False):
    """K1. q/k/v: (B, H, T, 64) bf16 or f32, before RoPE; cos/sin: (T, 64)
    f32 from ``rope_full_cache``; lens: (B,) valid key counts or None.
    Returns (B, H, T, 64) in q's dtype; with ``return_lse``, (out, lse):
    lse (B, H, T) f32 is the row log-sum-exp of the masked logits (K1ᵇ's
    statistics), None from the bf16 core, which does not write it."""
    if q.device.type == "cpu":
        out = dit_attention_fused_reference(q, k, v, cos, sin, lens)
        if not return_lse:
            return out
        return out, dit_attention_lse_reference(rope_scaled_reference(q, cos, sin),
                                                rope_scaled_reference(k, cos, sin), lens)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention_fused: unsupported device {q.device}")
    _check("dit_attention_fused", q, k, v, lens, (("cos", cos), ("sin", sin)))
    bf16 = q.dtype == torch.bfloat16
    fn = _kernel("dit_attention_fused_bf16" if bf16 else "dit_attention_fused_f32")
    # the pre-pass writes roped q and k here before the core reads them
    scratch = torch.empty((2, *q.shape), dtype=q.dtype, device=q.device)
    lse = None if bf16 else _lse_buffer(q, return_lse)
    out = _launch("dit_attention_fused", fn, q,
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr()),
                  lens, (scratch,) if bf16 else (lse, scratch))
    global LAUNCHES
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def dit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lens: torch.Tensor | None = None, return_lse: bool = False):
    """K3. q/k/v: (B, H, T, 64) bf16 or f32, q/k already roped; lens: (B,)
    valid key counts or None (every key valid). Returns (B, H, T, 64) in
    q's dtype; ``return_lse`` as in :func:`dit_attention_fused`."""
    if q.device.type == "cpu":
        out = dit_attention_reference(q, k, v, lens)
        return (out, dit_attention_lse_reference(q, k, lens)) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention: unsupported device {q.device}")
    _check("dit_attention", q, k, v, lens)
    bf16 = q.dtype == torch.bfloat16
    fn = _kernel("dit_attention_bf16" if bf16 else "dit_attention_f32")
    lse = None if bf16 else _lse_buffer(q, return_lse)
    out = _launch("dit_attention", fn, q, (q.data_ptr(), k.data_ptr(), v.data_ptr()), lens,
                  () if bf16 else (lse,))
    global DIT_ATTENTION_LAUNCHES
    DIT_ATTENTION_LAUNCHES += 1
    return (out, lse) if return_lse else out


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


def _bwd_scratch_floats(B: int, H: int, T: int, bf16: bool) -> int:
    """fp32 scratch of one K1ᵇ call: the roped, scaled q and k, the dq
    accumulator, dk and dv in fp32 (and f32 copies of v and dO for bf16
    inputs), and two row vectors (D, and the log-sum-exp when none is
    given)."""
    return (7 if bf16 else 5) * B * H * T * HEAD_DIM + 2 * B * H * T


def _bwd(op: str, q, k, v, cos, sin, lens, o, g, lse):
    extra = () if cos is None else (("cos", cos), ("sin", sin))
    _check(op, q, k, v, lens, extra)
    g = g.to(q.dtype).contiguous()
    for name, t in (("o", o), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{op}: {name} does not match q")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte aligned")
    B, H, T, _ = q.shape
    if lse is not None and (lse.shape != (B, H, T) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{op}: lse must be ({B}, {H}, {T}) f32, contiguous, on {q.device}")
    bf16 = q.dtype == torch.bfloat16
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty(_bwd_scratch_floats(B, H, T, bf16), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):  # the C side sets attributes of the current device
        err = _kernel("dit_attention_bwd", "attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos), _ptr(sin), _ptr(lens),
            o.data_ptr(), g.data_ptr(), _ptr(lse), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), B, H, T, int(bf16), int(cos is not None),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed (error {err})")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


def dit_attention_fused_bwd(q, k, v, cos, sin, lens, o, g, lse=None):
    """K1ᵇ for K1: (dq, dk, dv) in q's dtype. q/k/v (B, H, T, 64) before
    RoPE, cos/sin (T, 64) f32, lens (B,) int32 or None, o the forward's
    output, g its upstream gradient, lse the forward's (B, H, T) f32 row
    log-sum-exp or None (then K1ᵇ computes the statistics itself; the CPU's
    plain version needs none)."""
    if q.device.type == "cpu":
        return dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens, g)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention_fused_bwd: unsupported device {q.device}")
    return _bwd("dit_attention_fused_bwd", q, k, v, cos, sin, lens, o, g, lse)


def dit_attention_bwd(q, k, v, lens, o, g, lse=None):
    """K1ᵇ for K3: (dq, dk, dv) in q's dtype; q/k already roped."""
    if q.device.type == "cpu":
        return dit_attention_bwd_reference(q, k, v, lens, g)
    if q.device.type != "cuda":
        raise ValueError(f"dit_attention_bwd: unsupported device {q.device}")
    return _bwd("dit_attention_bwd", q, k, v, None, None, lens, o, g, lse)


class DitAttentionFusedFn(torch.autograd.Function):
    """K1 forward, K1ᵇ backward; no gradient to cos, sin or lens. The
    forward's row log-sum-exp is kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, lens):
        o, lse = dit_attention_fused(q, k, v, cos, sin, lens, return_lse=True)
        ctx.save_for_backward(q, k, v, cos, sin, lens, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, lens, o, lse = ctx.saved_tensors
        dq, dk, dv = dit_attention_fused_bwd(q, k, v, cos, sin, lens, o, g, lse)
        return dq, dk, dv, None, None, None


class DitAttentionFn(torch.autograd.Function):
    """K3 forward, K1ᵇ backward; no gradient to lens."""

    @staticmethod
    def forward(ctx, q, k, v, lens):
        o, lse = dit_attention(q, k, v, lens, return_lse=True)
        ctx.save_for_backward(q, k, v, lens, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lens, o, lse = ctx.saved_tensors
        dq, dk, dv = dit_attention_bwd(q, k, v, lens, o, g, lse)
        return dq, dk, dv, None


def dit_attention_fused_diff(q, k, v, cos, sin, lens=None):
    """``dit_attention_fused`` with K1ᵇ as its backward (trainable)."""
    return DitAttentionFusedFn.apply(q, k, v, cos, sin, lens)


def dit_attention_diff(q, k, v, lens=None):
    """``dit_attention`` with K1ᵇ as its backward (trainable)."""
    return DitAttentionFn.apply(q, k, v, lens)
