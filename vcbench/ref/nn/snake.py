"""Snake activations and the anti-aliased activation module (channels-first).

``snake``, ``upsample2x`` and ``downsample2x`` (the plain composition) live
beside the CUDA kernel in ``ops/anti_alias.py`` and are re-exported here.
``SnakeAlias`` calls ``anti_alias_snake``: the kernel for CUDA tensors, the
composition for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from vcbench.ref.ops.anti_alias import (  # noqa: F401
    anti_alias_snake, downsample2x, snake, upsample2x)


class SnakeAlias(nn.Module):
    """Activation1d: up2x -> snake/snakebeta -> down2x, in fp32."""

    def __init__(self, channels: int, snake_beta: bool = True, logscale: bool = True):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.logscale = logscale
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if snake_beta else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T) f32."""
        beta = self.beta if self.beta is not None else self.alpha
        return anti_alias_snake(x.contiguous(), self.alpha, beta, logscale=self.logscale)
