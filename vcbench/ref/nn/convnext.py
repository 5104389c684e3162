"""ConvNeXtV2 1-D stage, the ASTRAL quantizer's bottleneck encoder,
channels-last (B, T, C); the port's module code, frozen.

Blocks of depthwise-7 conv -> LayerNorm (eps 1e-6) -> pointwise MLP with
exact GELU and GRN (global response normalisation over time); optional
down/up-sampling before a block (LayerNorm, then a strided conv or transposed
conv) and 1x1 input/output projections.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GRN(nn.Module):
    """x * ||x||_2 over time, normalised by its channel mean, with raw
    ``gamma``/``beta`` leaves of shape (1, 1, C), as the flax module's."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt((x * x).sum(dim=1, keepdim=True))  # (B, 1, C)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class FlaxConvTranspose1d(nn.ConvTranspose1d):
    """``flax.linen.ConvTranspose`` with stride = kernel size and "SAME"
    padding: a PyTorch transposed conv with the kernel flipped in time (the
    weight bridge lands the flax kernel (K, in, out) as (in, out, K))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight.flip(-1), self.bias, self.stride)


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, dilation: int = 1):
        super().__init__()
        pad = dilation * (7 - 1) // 2
        self.dwconv = nn.Conv1d(dim, dim, 7, dilation=dilation, padding=pad, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = F.gelu(self.pwconv1(self.norm(h)))
        return x + self.pwconv2(self.grn(h))


class ConvNeXtV2Stage(nn.Module):
    def __init__(self, dim: int = 512, intermediate_dim: int = 2048, num_blocks: int = 1,
                 dilation: int = 1, input_dim: Optional[int] = None,
                 output_dim: Optional[int] = None,
                 downsample_layer_indices: Sequence[int] = (),
                 downsample_factors: Sequence[int] = (),
                 upsample_layer_indices: Sequence[int] = (),
                 upsample_factors: Sequence[int] = ()):
        super().__init__()
        self.num_blocks = num_blocks
        if input_dim is not None and input_dim != dim:
            self.input_projection = nn.Conv1d(input_dim, dim, 1)
        if output_dim is not None and output_dim != dim:
            self.output_projection = nn.Conv1d(dim, output_dim, 1)
        # block index -> resampling layer index, as the flax module's zip
        self.down = dict(zip(downsample_layer_indices, range(len(downsample_factors))))
        self.up = dict(zip(upsample_layer_indices, range(len(upsample_factors))))
        for i, j in self.down.items():
            f = downsample_factors[j]
            self.add_module(f"down_norm_{j}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"down_conv_{j}", nn.Conv1d(dim, dim, f, stride=f))
        for i, j in self.up.items():
            f = upsample_factors[j]
            self.add_module(f"up_norm_{j}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"up_conv_{j}", FlaxConvTranspose1d(dim, dim, f, stride=f))
        for i in range(num_blocks):
            self.add_module(f"blocks_{i}", ConvNeXtV2Block(dim, intermediate_dim, dilation))

    @staticmethod
    def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return conv(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C_in) -> (B, T', dim_out)."""
        if hasattr(self, "input_projection"):
            x = self._conv(self.input_projection, x)
        for i in range(self.num_blocks):
            if i in self.down:
                j = self.down[i]
                x = self._conv(getattr(self, f"down_conv_{j}"),
                               getattr(self, f"down_norm_{j}")(x))
            if i in self.up:
                j = self.up[i]
                x = self._conv(getattr(self, f"up_conv_{j}"), getattr(self, f"up_norm_{j}")(x))
            x = getattr(self, f"blocks_{i}")(x)
        if hasattr(self, "output_projection"):
            x = self._conv(self.output_projection, x)
        return x
