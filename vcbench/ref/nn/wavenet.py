"""Non-causal WaveNet stack, the DiT's post-net (port of ``seedvc_tpu/nn/wavenet.py``).

Per layer: a dilated conv to 2C channels (reflect-padded, as the reference's
SConv1d, or zero-padded with ``pad_mode="zero"``, as the plain VITS WN of the
OpenVoice converter), a slice of the
global conditioning, gated tanh*sigmoid, and res/skip 1x1 convs. The JAX
package writes its convs as shifted matmuls (``DilatedConvAsMatmul``, a TPU
rewrite); here they are plain ``Conv1d``s with the same weights.
Public layout (B, T, C), as in the JAX package; channels-first inside.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.nn.layers import Dense


class CastConv1d(nn.Conv1d):
    """``nn.Conv1d`` that computes in its input's dtype, casting its weights
    to it, as the JAX module's ``DilatedConvAsMatmul`` casts its kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class WaveNet(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, pad_mode: str = "reflect"):
        super().__init__()
        if pad_mode not in ("reflect", "zero"):
            raise ValueError(f"unknown pad_mode {pad_mode!r}")
        C = hidden_channels
        self.pad_mode = "reflect" if pad_mode == "reflect" else "constant"
        self.C, self.kernel_size, self.n_layers = C, kernel_size, n_layers
        self.dilation_rate = dilation_rate
        if gin_channels:
            self.cond_layer = Dense(gin_channels, 2 * C * n_layers)
        for i in range(n_layers):
            self.add_module(f"in_layers_{i}", CastConv1d(
                C, 2 * C, kernel_size, dilation=dilation_rate ** i))
            out_ch = 2 * C if i < n_layers - 1 else C
            self.add_module(f"res_skip_layers_{i}", CastConv1d(C, out_ch, 1))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor],
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, C); x_mask: (B, T, 1) or None; g: (B, 1, gin) or None."""
        C = self.C
        pads = [(self.kernel_size - 1) * self.dilation_rate ** i // 2 for i in range(self.n_layers)]
        x = x.transpose(1, 2)
        mask = None if x_mask is None else x_mask.transpose(1, 2)
        output = torch.zeros_like(x)
        g_all = None
        if g is not None and hasattr(self, "cond_layer"):
            g_all = self.cond_layer(g).transpose(1, 2)  # (B, 2*C*n_layers, 1)
        for i, pad in enumerate(pads):
            x_in = getattr(self, f"in_layers_{i}")(F.pad(x, (pad, pad), mode=self.pad_mode))
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * C:(i + 1) * 2 * C]
            acts = torch.tanh(x_in[:, :C]) * torch.sigmoid(x_in[:, C:])
            res_skip = getattr(self, f"res_skip_layers_{i}")(acts)
            if i < self.n_layers - 1:
                x = x + res_skip[:, :C]
                if mask is not None:
                    x = x * mask
                output = output + res_skip[:, C:]
            else:
                output = output + res_skip
        if mask is not None:
            output = output * mask
        return output.transpose(1, 2)
