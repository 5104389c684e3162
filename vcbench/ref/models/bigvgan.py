"""BigVGAN vocoder (NVIDIA bigvgan_v2 checkpoints), port of
``seedvc_tpu/models/bigvgan.py``, computed in f32.

conv_pre(7) -> per stage [ConvTranspose upsample -> mean of AMP resblocks]
-> anti-aliased snake post-activation -> conv_post(7) -> clamp (or tanh).
The JAX package writes its convs as shifted matmuls and the transposed conv
as a phase matmul (TPU rewrites); here they are ``Conv1d`` and
``ConvTranspose1d(k, stride=u, padding=(k-u)//2)`` with the same weights.
Public layout: mel (B, T, num_mels) in, wave (B, T * total_upsample) out;
channels-first (B, C, T) inside. Every activation is a ``SnakeAlias``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from vcbench.ref.nn.snake import SnakeAlias


@dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False

    @property
    def total_upsample(self) -> int:
        r = 1
        for u in self.upsample_rates:
            r *= u
        return r


BIGVGAN_22K_80 = BigVGANConfig()  # nvidia/bigvgan_v2_22khz_80band_256x
BIGVGAN_44K_128 = BigVGANConfig(  # nvidia/bigvgan_v2_44khz_128band_512x
    num_mels=128, upsample_rates=(8, 4, 2, 2, 2, 2),
    upsample_kernel_sizes=(16, 8, 4, 4, 4, 4))


class AMPBlock1(nn.Module):
    """Pairs of (anti-aliased snake -> dilated conv, anti-aliased snake ->
    conv) with residual adds."""

    def __init__(self, cfg: BigVGANConfig, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        sb = cfg.activation == "snakebeta"
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"act1_{i}", SnakeAlias(channels, sb, cfg.snake_logscale))
            self.add_module(f"convs1_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d, padding=(kernel_size - 1) // 2 * d))
            self.add_module(f"act2_{i}", SnakeAlias(channels, sb, cfg.snake_logscale))
            self.add_module(f"convs2_{i}", nn.Conv1d(
                channels, channels, kernel_size, padding=(kernel_size - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(getattr(self, f"act1_{i}")(x))
            x = x + getattr(self, f"convs2_{i}")(getattr(self, f"act2_{i}")(h))
        return x


class BigVGAN(nn.Module):
    def __init__(self, cfg: BigVGANConfig = BIGVGAN_22K_80):
        super().__init__()
        self.cfg = c = cfg
        self.conv_pre = nn.Conv1d(c.num_mels, c.upsample_initial_channel, 7, padding=3)
        ch = c.upsample_initial_channel
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            if k - 2 * ((k - u) // 2) != u:
                raise ValueError(f"upsample {i}: kernel {k} and stride {u} do not give T*u frames")
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(
                ch, ch // 2, k, stride=u, padding=(k - u) // 2))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i}_{j}", AMPBlock1(c, ch, rk, tuple(rd)))
        self.activation_post = SnakeAlias(ch, c.activation == "snakebeta", c.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=c.use_bias_at_final)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, num_mels) log-mel -> (B, T * total_upsample) waveform."""
        c = self.cfg
        x = self.conv_pre(mel.transpose(1, 2))
        n_res = len(c.resblock_kernel_sizes)
        for i in range(len(c.upsample_rates)):
            x = getattr(self, f"ups_{i}")(x)
            xs = getattr(self, f"resblocks_{i}_0")(x)
            for j in range(1, n_res):
                xs = xs + getattr(self, f"resblocks_{i}_{j}")(x)
            x = xs / n_res
        x = self.conv_post(self.activation_post(x))[:, 0]
        return torch.tanh(x) if c.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
