"""U-ViT transformer trunk of the v1 DiT (port of ``seedvc_tpu/nn/transformer.py``).

Per block: AdaptiveRMSNorm conditioned on the time embedding, RoPE attention
(K1, K3 or einsum, see ``nn.layers.Attention``), SwiGLU FFN. U-ViT skips:
blocks i < n_layer//2 push their outputs on a stack, blocks i > n_layer//2
pop one (LIFO) and mix it in through ``skip_in_linear``. The final norm is
adaptive as well. With ``time_as_token`` the time embedding travels as a
prefix token instead: every norm gets ``c=None`` and is the plain RMSNorm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from vcbench.ref.nn.layers import (AdaptiveRMSNorm, Attention, Dense, FeedForward,
                                   ffn_intermediate_size, rope_cache, rope_full_cache)


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
    time_as_token: bool = False
    use_flash: bool = False


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, receives_skip: bool = False):
        super().__init__()
        if receives_skip:
            self.skip_in_linear = Dense(2 * cfg.dim, cfg.dim)
        self.receives_skip = receives_skip
        conditioned = not cfg.time_as_token
        self.attention_norm = AdaptiveRMSNorm(cfg.dim, cfg.norm_eps, conditioned)
        self.attention = Attention(cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.head_dim,
                                   use_flash=cfg.use_flash)
        self.ffn_norm = AdaptiveRMSNorm(cfg.dim, cfg.norm_eps, conditioned)
        self.feed_forward = FeedForward(cfg.dim, ffn_intermediate_size(cfg.dim))

    def forward(self, x, c, freqs, lens, skip_in=None, rope_full=None):
        if self.receives_skip and skip_in is not None:
            x = self.skip_in_linear(torch.cat([x, skip_in.to(x.dtype)], dim=-1))
        h = x + self.attention(self.attention_norm(x, c), freqs, lens, rope_full)
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
        self.norm = AdaptiveRMSNorm(cfg.dim, cfg.norm_eps, not cfg.time_as_token)
        self._rope: dict = {}

    def rope_tables(self, T: int, device: torch.device):
        """(freqs, rope_full) for length T on ``device``, made once each:
        rope_full only where K1 can use it (flash, heads not grouped)."""
        key = (T, device)
        if key not in self._rope:
            cfg = self.cfg
            head_dim = cfg.head_dim or cfg.dim // cfg.n_head
            freqs = torch.from_numpy(rope_cache(T, head_dim, cfg.rope_base)).to(device)
            rope_full = None
            if cfg.use_flash and (cfg.n_local_heads or cfg.n_head) == cfg.n_head:
                rope_full = tuple(torch.from_numpy(a).to(device)
                                  for a in rope_full_cache(T, head_dim, cfg.rope_base))
            self._rope[key] = freqs, rope_full
        return self._rope[key]

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                lens: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, T, D); c: (B, 1, D) time embedding (unused with
        ``time_as_token``); lens: (B,) int32 valid key counts or None (every
        key valid)."""
        cfg = self.cfg
        freqs, rope_full = self.rope_tables(x.shape[1], x.device)
        c = None if cfg.time_as_token else c
        skips: list[torch.Tensor] = []
        for i in range(cfg.n_layer):
            skip_in = skips.pop() if i in self.recv and skips else None
            x = getattr(self, f"layers_{i}")(x, c, freqs, lens, skip_in, rope_full)
            if i in self.emit:
                skips.append(x)
        return self.norm(x, c)
