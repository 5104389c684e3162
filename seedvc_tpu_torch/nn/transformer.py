"""U-ViT transformer trunk of the v1 DiT (port of ``seedvc_tpu/nn/transformer.py``).

Per block: AdaptiveRMSNorm conditioned on the time embedding, RoPE attention,
SwiGLU FFN. U-ViT skips: blocks i < n_layer//2 push their outputs on a stack,
blocks i > n_layer//2 pop one (LIFO) and mix it in through ``skip_in_linear``.
The final norm is adaptive as well.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from seedvc_tpu_torch.nn.layers import (AdaptiveRMSNorm, Attention, FeedForward,
                                        ffn_intermediate_size, rope_full_cache)


@dataclass(frozen=True)
class TransformerConfig:
    dim: int
    n_layer: int
    n_head: int
    n_local_heads: int | None = None
    head_dim: int | None = None
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    uvit_skip_connection: bool = False


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, receives_skip: bool = False):
        super().__init__()
        if receives_skip:
            self.skip_in_linear = nn.Linear(2 * cfg.dim, cfg.dim)
        self.receives_skip = receives_skip
        self.attention_norm = AdaptiveRMSNorm(cfg.dim, cfg.norm_eps)
        self.attention = Attention(cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.head_dim)
        self.ffn_norm = AdaptiveRMSNorm(cfg.dim, cfg.norm_eps)
        self.feed_forward = FeedForward(cfg.dim, ffn_intermediate_size(cfg.dim))

    def forward(self, x, c, rope_full, lens, skip_in=None):
        if self.receives_skip and skip_in is not None:
            x = self.skip_in_linear(torch.cat([x, skip_in], dim=-1))
        h = x + self.attention(self.attention_norm(x, c), rope_full, lens)
        return h + self.feed_forward(self.ffn_norm(h, c))


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.uvit_skip_connection:
            self.emit = {i for i in range(cfg.n_layer) if i < cfg.n_layer // 2}
            self.recv = {i for i in range(cfg.n_layer) if i > cfg.n_layer // 2}
        else:
            self.emit, self.recv = set(), set()
        for i in range(cfg.n_layer):
            self.add_module(f"layers_{i}", TransformerBlock(cfg, receives_skip=i in self.recv))
        self.norm = AdaptiveRMSNorm(cfg.dim, cfg.norm_eps)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                lens: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, T, D); c: (B, 1, D) time embedding; lens: (B,) int32 valid
        key counts or None (every key valid)."""
        cfg = self.cfg
        head_dim = cfg.head_dim or cfg.dim // cfg.n_head
        rope_full = tuple(torch.from_numpy(a).to(x.device)
                          for a in rope_full_cache(x.shape[1], head_dim, cfg.rope_base))
        skips: list[torch.Tensor] = []
        for i in range(cfg.n_layer):
            skip_in = skips.pop() if i in self.recv and skips else None
            x = getattr(self, f"layers_{i}")(x, c, rope_full, lens, skip_in)
            if i in self.emit:
                skips.append(x)
        return self.norm(x, c)
