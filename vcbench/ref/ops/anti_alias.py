"""Plain anti-aliased SnakeBeta of the frozen reference: upsample2x -> snake
-> downsample2x in f32 on every device (the port's K2 twin)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vcbench.ref.dsp.filters import kaiser_sinc_filter1d

NO_DIV_BY_ZERO = 1e-9
KERNEL_SIZE = 12


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




def anti_alias_snake(x, alpha, beta, logscale=True):
    return anti_alias_snake_reference(x, alpha, beta, logscale)
