"""HiFT generator, the NSF + iSTFT vocoder of the real-time model (port of
``seedvc_tpu/models/hifigan.py``), computed in f32.

- ConvRNNF0Predictor predicts F0 from the mel;
- F0 is repeated up to the sample rate; :func:`sine_source` builds 9 harmonic
  sines with a cumulative phase, voiced/unvoiced gating and noise; a linear
  + tanh merges them into one source signal;
- the source's STFT (n_fft 16, hop 4, reflect-padded ``torch.stft``) is
  fused into the mel upsampling branch through ``source_downs`` convs and
  ResBlocks;
- mel branch: conv_pre -> per stage [leaky_relu -> ConvTranspose up ->
  (reflection pad (1, 0) at the last stage) -> + source -> mean of snake
  ResBlocks] -> leaky_relu (slope 0.01) -> conv_post -> magnitude exp
  (clipped at 1e2) and phase sin -> iSTFT -> clamp to +-0.99.

The JAX package writes the ResBlock convs as shifted matmuls and the source
STFT as a matmul DFT (TPU rewrites); here they are dilated ``Conv1d`` and
``torch.stft``. No activation here is anti-aliased, so no kernel of the
port runs in this module.

**Random draws.** The JAX module draws its phase (B, 1, H) uniform in
[-pi, pi) and its noise (B, T, H) normal from one PRNG key, and both JAX
pipelines pass ``PRNGKey(0)`` on every call, so every chunk and every block
gets the same draws. Here the draws are an explicit argument; by default
:meth:`HiFTGenerator.default_draws` makes them from a ``torch.Generator``
seeded with 0, the same on every call. Public layout: mel (B, T, 80) in,
wave (B, T * 256) out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.dsp.stft import istft


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 22050
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Sequence[int] = (8, 8)
    upsample_kernel_sizes: Sequence[int] = (16, 16)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    source_resblock_kernel_sizes: Sequence[int] = (7, 11)
    source_resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 2
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99

    @property
    def total_upsample(self) -> int:
        r = self.istft_hop
        for u in self.upsample_rates:
            r *= u
        return r


class Snake1(nn.Module):
    """Plain snake, x + sin(alpha x)^2 / (alpha + 1e-9), per-channel alpha,
    channels-first."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha[:, None]
        return x + (1.0 / (alpha + 1e-9)) * torch.sin(x * alpha) ** 2


class HiFTResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        k = kernel_size
        for i, d in enumerate(dilations):
            self.add_module(f"act1_{i}", Snake1(channels))
            self.add_module(f"convs1_{i}", nn.Conv1d(channels, channels, k, dilation=d,
                                                     padding=(k - 1) // 2 * d))
            self.add_module(f"act2_{i}", Snake1(channels))
            self.add_module(f"convs2_{i}", nn.Conv1d(channels, channels, k,
                                                     padding=(k - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(getattr(self, f"act1_{i}")(x))
            x = x + getattr(self, f"convs2_{i}")(getattr(self, f"act2_{i}")(h))
        return x


class ConvRNNF0Predictor(nn.Module):
    def __init__(self, in_channels: int = 80, cond_channels: int = 512):
        super().__init__()
        for i in range(5):
            self.add_module(f"condnet_{i}", nn.Conv1d(in_channels if i == 0 else cond_channels,
                                                      cond_channels, 3, padding=1))
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, 80) -> f0 (B, T)."""
        h = mel.transpose(1, 2)
        for i in range(5):
            h = F.elu(getattr(self, f"condnet_{i}")(h))
        return torch.abs(self.classifier(h.transpose(1, 2)))[..., 0]


def sine_source(phase: torch.Tensor, noise: torch.Tensor, f0_up: torch.Tensor,
                cfg: HiFTConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """SineGen with its draws given. f0_up: (B, T) Hz at the sample rate;
    phase: (B, 1, H) uniform in [-pi, pi) (harmonic 0's is ignored: set to
    0); noise: (B, T, H) standard normal; H = nb_harmonics + 1.
    Returns (sine_waves (B, T, H), uv (B, T, 1))."""
    H = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, H + 1, dtype=torch.float32, device=f0_up.device)
    f_mat = f0_up[:, :, None] * harmonics / cfg.sampling_rate
    # the scan runs over the last (contiguous) axis: along the outer axis of a
    # (B, T, 9) tensor CUDA's scan is two orders of magnitude slower
    phase_sum = torch.cumsum(f_mat.transpose(1, 2), dim=-1).transpose(1, 2)
    theta = 2 * math.pi * torch.remainder(phase_sum, 1.0)
    phase = torch.cat([torch.zeros_like(phase[..., :1]), phase[..., 1:]], dim=-1)
    sine_waves = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).to(torch.float32)[..., None]
    noise_amp = uv * cfg.nsf_sigma + (1 - uv) * cfg.nsf_alpha / 3
    return sine_waves * uv + noise_amp * noise, uv


def _stft_16(x: torch.Tensor, n_fft: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reflect-padded, centred STFT of (B, T) with a periodic Hann window ->
    (real, imag), each (B, frames, n_fft//2 + 1)."""
    window = torch.hann_window(n_fft, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    return spec.real.transpose(1, 2), spec.imag.transpose(1, 2)


class HiFTGenerator(nn.Module):
    def __init__(self, cfg: HiFTConfig = HiFTConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.f0_predictor = ConvRNNF0Predictor(c.in_channels)
        self.m_source_linear = nn.Linear(c.nb_harmonics + 1, 1)
        self.conv_pre = nn.Conv1d(c.in_channels, c.base_channels, 7, padding=3)
        n_stft = c.istft_n_fft + 2
        rates = list(c.upsample_rates)
        down_cum = [math.prod(([1] + rates[::-1][:-1])[: len(rates) - i])
                    for i in range(len(rates))]
        ch = c.base_channels
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(ch, ch // 2, k, stride=u,
                                                           padding=(k - u) // 2))
            ch //= 2
            du = down_cum[i]
            self.add_module(f"source_downs_{i}", nn.Conv1d(n_stft, ch, 1) if du == 1 else
                            nn.Conv1d(n_stft, ch, 2 * du, stride=du, padding=du // 2))
            self.add_module(f"source_resblocks_{i}", HiFTResBlock(
                ch, c.source_resblock_kernel_sizes[i], c.source_resblock_dilation_sizes[i]))
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i}_{j}", HiFTResBlock(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, n_stft, 7, padding=3)

    def default_draws(self, batch: int, n_samples: int,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
        """(phase (B, 1, H), noise (B, n_samples, H)) from a ``torch.Generator``
        seeded with 0: the same draws on every call, as the JAX pipelines'
        fixed key gives."""
        H = self.cfg.nb_harmonics + 1
        g = torch.Generator(device=device).manual_seed(0)
        phase = (torch.rand((batch, 1, H), generator=g, device=device) * 2 - 1) * math.pi
        noise = torch.randn((batch, n_samples, H), generator=g, device=device)
        return phase, noise

    def forward(self, mel: torch.Tensor, draws: tuple[torch.Tensor, torch.Tensor],
                f0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel: (B, T, 80) -> waveform (B, T * total_upsample); draws: see
        :func:`sine_source` (the pipelines make them once, by default with
        :meth:`default_draws`)."""
        c = self.cfg
        B, T, _ = mel.shape
        if f0 is None:
            f0 = self.f0_predictor(mel)
        # nearest upsampling to the sample rate (an expand: a CUDA graph
        # captures it without the host reading the output length)
        f0_up = f0[:, :, None].expand(B, T, c.total_upsample).reshape(B, -1)
        sines, _ = sine_source(*draws, f0_up, c)
        s = torch.tanh(self.m_source_linear(sines))[..., 0]
        re, im = _stft_16(s, c.istft_n_fft, c.istft_hop)
        s_stft = torch.cat([re, im], dim=-1).transpose(1, 2)  # (B, n_fft + 2, frames)

        x = self.conv_pre(mel.transpose(1, 2))
        n_stages, n_res = len(c.upsample_rates), len(c.resblock_kernel_sizes)
        for i in range(n_stages):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, c.lrelu_slope))
            if i == n_stages - 1:
                x = torch.cat([x[..., 1:2], x], dim=-1)  # reflection pad (1, 0)
            si = getattr(self, f"source_downs_{i}")(s_stft)
            x = x + getattr(self, f"source_resblocks_{i}")(si)
            xs = getattr(self, f"resblocks_{i}_0")(x)
            for j in range(1, n_res):
                xs = xs + getattr(self, f"resblocks_{i}_{j}")(x)
            x = xs / n_res

        x = self.conv_post(F.leaky_relu(x, 0.01))
        n_bins = c.istft_n_fft // 2 + 1
        magnitude = torch.clamp(torch.exp(x[:, :n_bins]), max=1e2).transpose(1, 2)
        phase = torch.sin(x[:, n_bins:]).transpose(1, 2)
        window = torch.hann_window(c.istft_n_fft, dtype=x.dtype, device=x.device)
        wave = istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase),
                     c.istft_n_fft, c.istft_hop, window)
        return torch.clamp(wave, -c.audio_limit, c.audio_limit)
