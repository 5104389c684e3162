"""Binary spherical quantization (port of ``seedvc_tpu/nn/bsq.py``), and the
host helper ``duration_reduction``.

``project_in`` to log2(codebook_size) bits, l2-normalise times
``codebook_scale`` (``spherical``), quantize each bit by its sign to
+-codebook_scale, pack the bits big-endian (bit i weighs 2^(D-1-i)) into the
index, normalise the quantized vector again and ``project_out``. With
``training=True``:

- the straight-through estimator: the forward value is the quantized
  vector, the gradient that of the normalised projection ``h``;
- the aux loss ``entropy_loss_weight`` x the soft entropy of ``h`` (the
  mean per-bit Bernoulli entropy of ``p = sigmoid(2 scale h / tau)`` minus
  ``diversity_gamma`` x the entropy of the batch-mean bit probabilities),
  plus ``commitment_loss_weight`` x MSE(h, quantized) when that weight is
  above 0.

With ``pmean_axis`` the batch-mean bit probabilities are averaged over
that mesh axis (of the innermost ``parallel.mesh.set_mesh`` block) before
their entropy, as the JAX module's ``jax.lax.pmean``: forward the mean over
the axis's ranks, backward the mean of their gradients.
``GroupedResidualBSQ`` quantizes equal feature-dim chunks with independent
BSQs (``rvqs_{i}``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from seedvc_tpu_torch.parallel.collectives import pmean
from seedvc_tpu_torch.parallel.mesh import current_mesh


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=eps)


def entropy(prob: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return (-prob * torch.log(torch.clamp(prob, min=eps))).sum(-1)


class BSQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int, codebook_scale: float = 1.0,
                 spherical: bool = True, entropy_loss_weight: float = 0.1,
                 commitment_loss_weight: float = 0.0, diversity_gamma: float = 1.0,
                 inv_temperature: float = 1.0, pmean_axis: Optional[str] = None):
        super().__init__()
        self.pmean_axis = pmean_axis
        self.codebook_dim = int(math.log2(codebook_size))
        self.codebook_scale = codebook_scale
        self.spherical = spherical
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.diversity_gamma = diversity_gamma
        self.inv_temperature = inv_temperature
        self.project_in = nn.Linear(dim, self.codebook_dim)
        self.project_out = nn.Linear(self.codebook_dim, dim)

    def _maybe_l2norm(self, t: torch.Tensor) -> torch.Tensor:
        return l2norm(t) * self.codebook_scale if self.spherical else t

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The normalised projection whose signs are the bits."""
        return self._maybe_l2norm(self.project_in(x))

    def indices(self, h: torch.Tensor) -> torch.Tensor:
        """The bits of ``h``'s signs packed big-endian into (B, T) int64."""
        mask = 2 ** torch.arange(self.codebook_dim - 1, -1, -1, device=h.device)
        return ((h > 0).long() * mask).sum(-1)

    def forward(self, x: torch.Tensor, training: bool = False):
        """x: (B, T, dim) -> (quantized (B, T, dim), indices (B, T) int64,
        aux_loss (), 0 unless ``training``)."""
        h = self.project(x)
        scale = torch.full_like(h, self.codebook_scale)
        quantized = torch.where(h > 0, scale, -scale)
        indices = self.indices(h)
        q_out = self._maybe_l2norm(quantized)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if training:
            q_out = h + (q_out - h).detach()
            aux = self.entropy_loss_weight * self._soft_entropy_loss(h)
            if self.commitment_loss_weight > 0:
                commit = torch.mean((h - quantized.detach()) ** 2)
                aux = aux + self.commitment_loss_weight * commit
        return self.project_out(q_out), indices, aux

    def _soft_entropy_loss(self, h: torch.Tensor) -> torch.Tensor:
        """Per-bit Bernoulli entropies: p(bit i = 1) = sigmoid(2 scale h_i tau)."""
        p = torch.sigmoid(2 * self.codebook_scale * h * self.inv_temperature)
        p = torch.stack([p, 1 - p], dim=-1)
        per_sample = entropy(p).sum(-1).mean()
        avg_prob = p.reshape(-1, p.shape[-2], 2).mean(dim=0)
        if self.pmean_axis is not None:
            avg_prob = pmean(avg_prob, current_mesh(self.pmean_axis).group(self.pmean_axis))
        codebook = entropy(avg_prob).sum(-1).mean()
        return per_sample - self.diversity_gamma * codebook


class GroupedResidualBSQ(nn.Module):
    """Split the feature dimension into ``groups`` equal chunks, quantize each
    with its own BSQ (``rvqs_{i}``), concatenate the quantized chunks and stack
    the indices: (quantized (B, T, dim), indices (groups, B, T), aux (groups,))."""

    def __init__(self, dim: int, groups: int, codebook_size: int, **bsq_kwargs):
        super().__init__()
        if dim % groups:
            raise ValueError("dim must divide into groups")
        self.groups = groups
        for i in range(groups):
            self.add_module(f"rvqs_{i}", BSQ(dim // groups, codebook_size, **bsq_kwargs))

    def forward(self, x: torch.Tensor, training: bool = False):
        outs = [getattr(self, f"rvqs_{i}")(chunk, training=training)
                for i, chunk in enumerate(torch.chunk(x, self.groups, dim=-1))]
        return (torch.cat([o[0] for o in outs], dim=-1), torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))


def duration_reduction(tokens: np.ndarray) -> tuple[np.ndarray, int]:
    """Collapse runs of identical tokens (copy of the JAX package's host
    helper): (deduplicated tokens, their count)."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return tokens, 0
    keep = np.concatenate([[True], tokens[1:] != tokens[:-1]])
    out = tokens[keep]
    return out, len(out)


def run_lengths(tokens: np.ndarray) -> np.ndarray:
    """The length of each run of identical tokens, in order: the duration of
    each token :func:`duration_reduction` keeps."""
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return np.zeros(0, np.int64)
    starts = np.flatnonzero(np.concatenate([[True], tokens[1:] != tokens[:-1]]))
    return np.diff(np.append(starts, tokens.size)).astype(np.int64)
