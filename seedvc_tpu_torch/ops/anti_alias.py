"""Anti-aliased SnakeBeta activation: the CUDA kernel's wrapper and its plain twin.

Replaces ``seedvc_tpu/ops/pallas/anti_alias.py::anti_alias_snake`` (TPU kernel
bodies ``_make_kernel_clean`` for C > 64 and ``_make_kernel_grouped`` for
C <= 64, reached through ``_anti_alias_grouped``). One CUDA kernel,
``seedvc_tpu_torch/csrc/anti_alias.cu``, covers every channel count:

- what bounds it on the H100: bytes. The function reads each input sample once
  and writes each output once (8 bytes per element in fp32). Its arithmetic,
  24 FIR FMAs and two polynomial sin^2 per output, issues in less time than
  that; the first port of this kernel, with two accurate ``sinf``, scalar
  shared-memory traffic and clamps on every tap, was bound by issue instead.
- what the design does about it: the unfused composition writes the 2x
  upsampled signal and its snake to device memory and reads them back; the
  kernel keeps them in shared memory, so device memory sees one read and one
  write per element, as 16-byte accesses. sin^2 is the TPU kernel's
  range-reduced polynomial on the FMA pipe, the FIR loops run without clamps
  (only a row's edge tiles patch the u-space clamps), and one call is one
  launch: the kernel forms exp(alpha) and 1/(exp(beta) + 1e-9) itself and
  takes the taps and the sin^2 constants (:func:`kernel_constants`) by value.

Layout is the port's (B, C, T), time contiguous. The up/snake/down pieces of
the plain composition live here too, and ``nn/snake.py`` re-exports them.
A CPU tensor goes to :func:`anti_alias_snake_reference`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from seedvc_tpu_torch.dsp.filters import kaiser_sinc_filter1d
from seedvc_tpu_torch.ops.build import load_library

NO_DIV_BY_ZERO = 1e-9
KERNEL_SIZE = 12
LAUNCHES = 0

# cos(theta) on theta^2 in [0, pi^2], a degree-7 least-squares fit: the TPU
# kernel's ``_COS_C`` (seedvc_tpu/ops/pallas/anti_alias.py), copied.
_COS_C = (1.0000000001396678, -0.49999999903985304, 0.04166666418826992,
          -0.0013888867475997221, 2.4800691078186138e-05,
          -2.7536987215763688e-07, 2.0620714282439055e-09,
          -9.7749677186398614e-12)

_P = ctypes.c_void_p


def kernel_constants() -> np.ndarray:
    """The 35 float32 constants the kernel takes by value (``Consts`` in
    ``anti_alias.cu``): the up-FIR taps 2 f (ratio folded in), the down-FIR
    taps f, the sin^2 coefficients and 1/pi, pi split in two (Cody-Waite).

    With z = y - n pi, n = round(y / pi): sin^2(y) = 1/2 - cos(2z)/2
    = sum_k d_k (z^2)^k, d_0 = (1 - c_0)/2, d_k = -c_k 4^k / 2, the TPU
    kernel's polynomial in theta^2 = 4 z^2 with the 1/2 - 1/2 folded in."""
    f = kaiser_sinc_filter1d(0.25, 0.3, KERNEL_SIZE).astype(np.float64)
    sin2 = [0.5 - 0.5 * _COS_C[0]] + [-0.5 * c * 4.0 ** k for k, c in enumerate(_COS_C) if k]
    pi_hi = float(np.float32(np.pi))
    return np.array([*(2 * f), *f, *sin2, 1 / np.pi, pi_hi, np.pi - pi_hi], np.float32)


_CONSTS = kernel_constants()


def _lib():
    lib = load_library("anti_alias")
    lib.anti_alias_snake_f32.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, _P]
    lib.anti_alias_snake_f32.restype = ctypes.c_int
    return lib


def _filter(device, ratio: int = 2, kernel_size: int = KERNEL_SIZE) -> torch.Tensor:
    return torch.from_numpy(kaiser_sinc_filter1d(
        0.5 / ratio, 0.6 / ratio, kernel_size)).to(device)


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor | None = None,
          logscale: bool = True) -> torch.Tensor:
    """x: (B, C, T); alpha/beta: (C,). beta=None -> classic Snake (beta=alpha)."""
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta) if beta is not None else alpha
    elif beta is None:
        beta = alpha
    s = torch.sin(x * alpha[:, None])
    return x + (1.0 / (beta + NO_DIV_BY_ZERO))[:, None] * (s * s)


def upsample2x(x: torch.Tensor, kernel_size: int = KERNEL_SIZE, ratio: int = 2) -> torch.Tensor:
    """Anti-aliased 2x upsample of (B, C, T): replicate pad, depthwise
    transposed FIR (ratio * filter), trim (reference UpSample1d)."""
    C = x.shape[1]
    filt = _filter(x.device, ratio, kernel_size).to(x.dtype)
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, filt.expand(C, 1, kernel_size), stride=ratio,
                                   groups=C)
    return y[..., pad_left: y.shape[-1] - pad_right]


def downsample2x(x: torch.Tensor, kernel_size: int = KERNEL_SIZE, ratio: int = 2) -> torch.Tensor:
    """Anti-aliased 2x downsample of (B, C, T) (reference DownSample1d)."""
    C = x.shape[1]
    filt = _filter(x.device, ratio, kernel_size).to(x.dtype)
    even = kernel_size % 2 == 0
    x = F.pad(x, (kernel_size // 2 - int(even), kernel_size // 2), mode="replicate")
    return F.conv1d(x, filt.expand(C, 1, kernel_size), stride=ratio, groups=C)


def anti_alias_snake_reference(x, alpha, beta, logscale: bool = True):
    """Plain twin of the kernel: upsample2x -> snake -> downsample2x in fp32."""
    h = upsample2x(x.float())
    h = snake(h, alpha.float(), beta.float(), logscale)
    return downsample2x(h).to(x.dtype)


def anti_alias_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     logscale: bool = True) -> torch.Tensor:
    """Fused up2x -> SnakeBeta -> down2x. x: (B, C, T) f32; alpha/beta: (C,)."""
    if x.device.type == "cpu":
        return anti_alias_snake_reference(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"anti_alias_snake: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("anti_alias_snake: x must be a contiguous (B, C, T) f32 tensor")
    B, C, T = x.shape
    if T < 1:
        raise ValueError("anti_alias_snake: empty time axis")
    for name, p in (("alpha", alpha), ("beta", beta)):
        if p.shape != (C,) or p.device != x.device:
            raise ValueError(f"anti_alias_snake: {name} must be ({C},) on {x.device}")
    # no-ops for the f32 parameters of the main path: no device work here
    alpha, beta = alpha.float().contiguous(), beta.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().anti_alias_snake_f32(
            x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), _CONSTS.ctypes.data,
            out.data_ptr(), B, C, T, int(logscale), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"anti_alias_snake: CUDA launch failed (error {err})")
    global LAUNCHES
    LAUNCHES += 1
    return out
