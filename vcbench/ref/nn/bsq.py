"""Binary spherical quantization at inference, the port's module code frozen
(its training half, the straight-through estimator and the entropy loss,
left out), and the host helpers ``duration_reduction`` and ``run_lengths``.

``project_in`` to log2(codebook_size) bits, l2-normalise times
``codebook_scale``, quantize each bit by its sign to +-codebook_scale, pack
the bits big-endian (bit i weighs 2^(D-1-i)) into the index, normalise the
quantized vector again and ``project_out``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=eps)


class BSQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int, codebook_scale: float = 1.0):
        super().__init__()
        self.codebook_dim = int(math.log2(codebook_size))
        self.codebook_scale = codebook_scale
        self.project_in = nn.Linear(dim, self.codebook_dim)
        self.project_out = nn.Linear(self.codebook_dim, dim)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The normalised projection whose signs are the bits."""
        return l2norm(self.project_in(x)) * self.codebook_scale

    def forward(self, x: torch.Tensor):
        """x: (B, T, dim) -> (quantized (B, T, dim), indices (B, T) int64)."""
        h = self.project(x)
        scale = torch.full_like(h, self.codebook_scale)
        quantized = torch.where(h > 0, scale, -scale)
        mask = 2 ** torch.arange(self.codebook_dim - 1, -1, -1, device=x.device)
        indices = ((quantized > 0).long() * mask).sum(-1)
        return self.project_out(l2norm(quantized) * self.codebook_scale), indices


def duration_reduction(tokens: np.ndarray) -> tuple[np.ndarray, int]:
    """Collapse runs of identical tokens: (deduplicated tokens, their count)."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return tokens, 0
    keep = np.concatenate([[True], tokens[1:] != tokens[:-1]])
    out = tokens[keep]
    return out, len(out)


def run_lengths(tokens: np.ndarray) -> np.ndarray:
    """The length of each run of identical tokens, in order."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return np.zeros(0, np.int64)
    starts = np.flatnonzero(np.concatenate([[True], tokens[1:] != tokens[:-1]]))
    return np.diff(np.append(starts, tokens.size)).astype(np.int64)
