"""Binary spherical quantization in inference (port of the inference half of
``seedvc_tpu/nn/bsq.py``), and the host helper ``duration_reduction``.

``project_in`` to log2(codebook_size) bits, l2-normalise, quantize each bit
by its sign to +-1, pack the bits big-endian (bit i weighs 2^(D-1-i)) into
the index, l2-normalise the quantized vector and ``project_out``: the
spherical BSQ with codebook scale 1 that ASTRAL builds. The training terms
(straight-through, soft entropy, commitment) and ``GroupedResidualBSQ`` wait
for the training slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=eps)


class BSQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.codebook_dim = int(math.log2(codebook_size))
        self.project_in = nn.Linear(dim, self.codebook_dim)
        self.project_out = nn.Linear(self.codebook_dim, dim)

    def forward(self, x: torch.Tensor, training: bool = False):
        """x: (B, T, dim) -> (quantized (B, T, dim), indices (B, T) int64,
        aux_loss 0)."""
        if training:
            raise NotImplementedError("BSQ training terms are not ported: ROADMAP queue 1 "
                                      "item 3b (the v2 trainer)")
        h = l2norm(self.project_in(x))
        quantized = torch.where(h > 0, 1.0, -1.0).to(h.dtype)
        mask = 2 ** torch.arange(self.codebook_dim - 1, -1, -1, device=x.device)
        indices = ((quantized > 0).long() * mask).sum(-1)
        out = self.project_out(l2norm(quantized))
        return out, indices, torch.zeros((), device=x.device)


def duration_reduction(tokens: np.ndarray) -> tuple[np.ndarray, int]:
    """Collapse runs of identical tokens (copy of the JAX package's host
    helper): (deduplicated tokens, their count)."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return tokens, 0
    keep = np.concatenate([[True], tokens[1:] != tokens[:-1]])
    out = tokens[keep]
    return out, len(out)
