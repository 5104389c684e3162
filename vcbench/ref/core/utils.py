"""Small shared utilities."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask of shape (B, max_length), True where t < lengths[b]."""
    positions = torch.arange(max_length, device=lengths.device)[None, :]
    return positions < lengths[:, None]

