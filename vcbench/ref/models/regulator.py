"""Length regulator: content features -> mel-rate conditioning
(port of ``seedvc_tpu/models/regulator.py``).

Embed discrete tokens (one codebook, or several summed with codebook i
gated by ``n_quantizers > i``) or project continuous content, nearest-interpolate it along time to ``ylens.max()``,
add the quantised-F0 embedding (or a learned mask when F0 conditioning is on
and no F0 is given), then a conv -> GroupNorm(1) -> Mish stack and a 1x1
projection. The output
buffer has a fixed length ``target_len``; positions past ``ylens.max()`` are
zeroed before every conv and excluded from the GroupNorm statistics, so the
result equals running on a tensor that really ends there. With
``vector_quantize`` on continuous content, a DAC-style VQ bottleneck
(:class:`VectorQuantize`) follows, with its commitment and codebook losses and
the straight-through estimator. :func:`random_n_quantizers` turns the
training draw of per-sample active codebooks into counts.

Returns ``(out, ylens, codes, commitment_loss, codebook_loss)`` as the JAX
module does; the last three are None without VQ.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.core.config import LengthRegulatorConfig
from vcbench.ref.core.utils import sequence_mask

F0_MIN = 50.0
F0_MAX = 1100.0
F0_MEL_MIN = 1127.0 * np.log(1 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor, f0_bin: int) -> torch.Tensor:
    """Mel-scale coarse F0 bins, int64. Rounds half to even (as the JAX
    package's ``jnp.round``); unvoiced (0 Hz) maps to bin 1 and bins
    ``>= f0_bin`` wrap to 0."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    a = (f0_bin - 2) / (F0_MEL_MAX - F0_MEL_MIN)
    b = F0_MEL_MIN * a - 1.0
    f0_mel = torch.where(f0_mel > 0, f0_mel * a - b, f0_mel)
    coarse = torch.round(f0_mel).long()
    coarse = coarse * (coarse > 0)
    coarse = coarse + (coarse < 1)
    return coarse * (coarse < f0_bin)


def nearest_interpolate_to(x: torch.Tensor, out_len: torch.Tensor, target_len: int,
                           in_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T_in, C) -> (B, target_len, C), nearest, with torch's float
    ``floor(j * float(in/out))`` index rule; only the first ``in_len`` input
    frames are read. Positions >= out_len are garbage for the caller to mask."""
    t_in = in_len if in_len is not None else torch.tensor(x.shape[1], device=x.device)
    t_in = t_in.to(torch.float32)
    scale = t_in / torch.clamp(out_len.to(torch.float32), min=1.0)
    j = torch.arange(target_len, dtype=torch.float32, device=x.device)
    idx = torch.floor(j * scale).long()
    idx = torch.minimum(idx, t_in.long() - 1)
    return x[:, idx]


class MaskedGroupNorm(nn.Module):
    """GroupNorm(1, C) whose statistics span only the first ``out_len`` time
    positions of a padded buffer. Input (B, C, T)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, h: torch.Tensor, valid: torch.Tensor,
                out_len: torch.Tensor) -> torch.Tensor:
        C = h.shape[1]
        hf = h.float()
        n = torch.clamp(out_len.float(), min=1.0) * C
        mean = (hf * valid).sum(dim=(1, 2), keepdim=True) / n
        var = (((hf - mean) ** 2) * valid).sum(dim=(1, 2), keepdim=True) / n
        normed = (hf - mean) * torch.rsqrt(var + self.eps)
        return (normed * self.weight[:, None] + self.bias[:, None]).to(h.dtype)


class VectorQuantize(nn.Module):
    """DAC-style VQ: project to ``codebook_dim``, pick the nearest code by
    cosine similarity, straight-through estimator, then project out.
    Returns (out, commitment_loss, codebook_loss, codes); the losses are
    means over every element of the (B, T, codebook_dim) codes, padding
    included, as in the JAX module."""

    def __init__(self, in_dim: int, codebook_size: int, codebook_dim: int = 8,
                 out_dim: int = 512):
        super().__init__()
        self.in_proj = nn.Linear(in_dim, codebook_dim)
        self.codebook = nn.Parameter(torch.randn(codebook_size, codebook_dim))
        self.out_proj = nn.Linear(codebook_dim, out_dim)

    def forward(self, z: torch.Tensor):
        z_e = self.in_proj(z)
        e = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-8)
        cb = self.codebook / (torch.linalg.vector_norm(self.codebook, dim=-1, keepdim=True)
                              + 1e-8)
        codes = torch.argmax(torch.einsum("btd,kd->btk", e, cb), dim=-1)
        z_q = self.codebook[codes]
        commitment_loss = torch.mean((z_e - z_q.detach()) ** 2)
        codebook_loss = torch.mean((z_e.detach() - z_q) ** 2)
        z_q = z_e + (z_q - z_e).detach()  # straight-through
        return self.out_proj(z_q), commitment_loss, codebook_loss, codes


def random_n_quantizers(counts: torch.Tensor, n_codebooks: int,
                        quantizer_dropout: float) -> torch.Tensor:
    """Per-sample active codebooks for training: the first
    ``int(B * quantizer_dropout)`` samples use their drawn count (``counts``,
    (B,) ints in [1, n_codebooks], the JAX package's
    ``randint(key, (B,), 1, n_codebooks + 1)``), the rest use all."""
    B = counts.shape[0]
    n_drop = int(B * quantizer_dropout)
    full = torch.full_like(counts, n_codebooks)
    return torch.where(torch.arange(B, device=counts.device) < n_drop, counts, full)


class InterpolateRegulator(nn.Module):
    def __init__(self, cfg: LengthRegulatorConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.is_discrete:
            self.embedding = nn.Embedding(cfg.content_codebook_size, cfg.channels)
            for i in range(1, cfg.n_codebooks):
                self.add_module(f"extra_codebooks_{i - 1}",
                                nn.Embedding(cfg.content_codebook_size, cfg.channels))
        else:
            self.content_in_proj = nn.Linear(cfg.in_channels, cfg.channels)
        if cfg.f0_condition:
            self.f0_mask = nn.Parameter(torch.zeros(1, cfg.channels))
            self.f0_embedding = nn.Embedding(cfg.n_f0_bins, cfg.channels)
        for i in range(len(cfg.sampling_ratios)):
            self.add_module(f"conv_{i}", nn.Conv1d(cfg.channels, cfg.channels, 3, padding=1))
            self.add_module(f"norm_{i}", MaskedGroupNorm(cfg.channels))
        self.out_proj = nn.Linear(cfg.channels, cfg.channels)
        if cfg.vector_quantize and not cfg.is_discrete:
            self.vq = VectorQuantize(cfg.channels, cfg.content_codebook_size,
                                     out_dim=cfg.channels)

    def forward(self, x: torch.Tensor, ylens: torch.Tensor, target_len: int,
                f0: Optional[torch.Tensor] = None, x_lens: Optional[torch.Tensor] = None,
                f0_lens: Optional[torch.Tensor] = None,
                n_quantizers: Optional[torch.Tensor] = None):
        """x: (B, T_in, C_in) continuous content, or int tokens (B, T_in) or
        (B, n_q, T_in); ylens: (B,) target lengths; target_len: the output
        buffer length; f0: (B, T_f0) Hz or None; x_lens / f0_lens: () true
        content / F0 lengths inside their buffers, or None; n_quantizers: (B,)
        active codebooks of a multi-codebook x (None: all).
        Returns (out (B, target_len, channels), ylens, codes, commitment_loss,
        codebook_loss); the last three are None without VQ. The regulator
        computes in f32 whatever x's float type (the JAX module's Dense
        promotes a bf16 x with its f32 weights)."""
        c = self.cfg
        if not c.is_discrete:
            h = self.content_in_proj(x.to(self.content_in_proj.weight.dtype))
        elif x.dim() == 3:
            if n_quantizers is None:
                n_quantizers = torch.full((x.shape[0],), c.n_codebooks, device=x.device)
            h = self.embedding(x[:, 0])
            for i in range(1, c.n_codebooks):
                gate = (n_quantizers > i)[:, None, None].to(h.dtype)
                h = h + gate * getattr(self, f"extra_codebooks_{i - 1}")(x[:, i])
        else:
            h = self.embedding(x)
        out_len = ylens.max()
        h = nearest_interpolate_to(h, out_len, target_len, in_len=x_lens)
        if c.f0_condition:
            if f0 is None:
                h = h + self.f0_mask[None]
            else:
                q = torch.clamp(f0_to_coarse(f0, c.n_f0_bins), 0, c.n_f0_bins - 1)
                h = h + nearest_interpolate_to(self.f0_embedding(q), out_len, target_len,
                                               in_len=f0_lens)
        valid = (torch.arange(target_len, device=x.device) < out_len).to(h.dtype)[None, None]
        h = h.transpose(1, 2) * valid
        for i in range(len(c.sampling_ratios)):
            h = getattr(self, f"conv_{i}")(h)
            h = getattr(self, f"norm_{i}")(h, valid, out_len)
            h = h * torch.tanh(F.softplus(h)) * valid  # Mish
        out = self.out_proj(h.transpose(1, 2))
        mask = sequence_mask(ylens, target_len)[..., None].to(out.dtype)
        if c.vector_quantize and not c.is_discrete:
            out_q, commit, cb_loss, codes = self.vq(out)
            return out_q * mask, ylens, codes, commit, cb_loss
        return out * mask, ylens, None, None, None
