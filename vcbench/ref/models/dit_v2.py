"""v2 DiT estimator with AdaLN-Zero modulation, the port's module code
frozen, channels-last (B, T, C), on one device (no time split).

[x ‖ prompt_x ‖ projected cond] merge through one linear
(``cond_x_merge_linear``). The style token and then the time token are
prepended, so the sequence is ``[time, style, x...]``: keys are valid below
``x_lens + 2`` and RoPE spans the prefix. Blocks use a 6-way AdaLN-Zero
split (shift, scale, gate for attention and for the MLP, from silu(time));
the final adaptive norm uses the (scale, shift) chunk order. Attention is
K1's plain twin (``ops/attention.py``). Classifier-free dropout, a training
input, is not part of this copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.models.dit import SplitDense
from vcbench.ref.nn.layers import (Attention, FeedForward, RMSNorm, TimestepEmbedder,
                                   ffn_intermediate_size, rope_cache, rope_full_cache)


@dataclass(frozen=True)
class DiTV2Config:
    hidden_dim: int = 512
    depth: int = 13
    num_heads: int = 8
    in_channels: int = 80
    content_dim: int = 512
    style_encoder_dim: int = 192
    class_dropout_prob: float = 0.1
    time_as_token: bool = True
    style_as_token: bool = True
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    use_flash_attention: bool = True
    flash_block_q: int = 640


class AdaLNZeroBlock(nn.Module):
    def __init__(self, cfg: DiTV2Config):
        super().__init__()
        d = cfg.hidden_dim
        self.adaln_linear = nn.Linear(d, 6 * d)
        self.attention_norm = RMSNorm(d, cfg.norm_eps)
        self.attention = Attention(d, cfg.num_heads, head_dim=d // cfg.num_heads,
                                   use_flash=cfg.use_flash_attention)
        self.ffn_norm = RMSNorm(d, cfg.norm_eps)
        self.feed_forward = FeedForward(d, ffn_intermediate_size(d))

    def forward(self, x, c, freqs, lens, rope_full=None):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaln_linear(F.silu(c)).chunk(6, dim=-1)
        h = self.attention_norm(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attention(h, freqs, lens, rope_full)
        h = self.ffn_norm(x) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.feed_forward(h)


class DiTV2(nn.Module):
    def __init__(self, cfg: DiTV2Config):
        super().__init__()
        self.cfg = cfg
        d, C = cfg.hidden_dim, cfg.in_channels
        self.cond_projection = nn.Linear(cfg.content_dim, d)
        self.cond_x_merge_linear = SplitDense(C + C + d, d)
        self.style_in = nn.Linear(cfg.style_encoder_dim, d)
        self.t_embedder = TimestepEmbedder(d)
        for i in range(cfg.depth):
            self.add_module(f"layers_{i}", AdaLNZeroBlock(cfg))
        self.final_adaln_linear = nn.Linear(d, 2 * d)
        self.final_norm = RMSNorm(d, cfg.norm_eps)
        self.final_mlp0 = nn.Linear(d, d)
        self.final_mlp2 = nn.Linear(d, C)

    def rope_tables(self, T: int, device: torch.device):
        cfg = self.cfg
        hd = cfg.hidden_dim // cfg.num_heads
        freqs = torch.from_numpy(rope_cache(T, hd, cfg.rope_base)).to(device)
        rope_full = None
        if cfg.use_flash_attention:
            rope_full = tuple(torch.from_numpy(a).to(device)
                              for a in rope_full_cache(T, hd, cfg.rope_base))
        return freqs, rope_full

    def forward(self, x, prompt_x, x_lens, t, style, cond, return_static: bool = False,
                static_cond: Optional[dict] = None):
        """x, prompt_x: (B, T, C_mel); x_lens: (B,) or None; t: (B,);
        style: (B, S); cond: (B, T, content_dim). ``return_static=True``
        returns the step-invariant conditioning; passing it back as
        ``static_cond`` skips recomputing it."""
        cfg = self.cfg
        B, T, C = x.shape
        if static_cond is None:
            merged_static = self.cond_x_merge_linear(
                torch.cat([prompt_x, self.cond_projection(cond)], dim=-1), C, True)
            style_tok = self.style_in(style)
            if return_static:
                return {"merged": merged_static, "style_tok": style_tok}
        else:
            merged_static, style_tok = static_cond["merged"], static_cond["style_tok"]

        t1 = self.t_embedder(t)
        x_in = self.cond_x_merge_linear(x, 0, False) + merged_static
        prefix = []
        if cfg.time_as_token:
            prefix.append(t1[:, None, :].to(x.dtype))
        if cfg.style_as_token:
            prefix.append(style_tok[:, None, :])
        n_prefix = len(prefix)
        if prefix:
            x_in = torch.cat([*prefix, x_in], dim=1)
        lens = None if x_lens is None else (x_lens + n_prefix).to(torch.int32)
        freqs, rope_full = self.rope_tables(T + n_prefix, x.device)
        c = t1[:, None, :]
        h = x_in
        for i in range(cfg.depth):
            h = getattr(self, f"layers_{i}")(h, c, freqs, lens, rope_full)
        scale, shift = self.final_adaln_linear(F.silu(c)).chunk(2, dim=-1)
        h = (self.final_norm(h) * (1 + scale) + shift)[:, n_prefix:]
        return self.final_mlp2(F.silu(self.final_mlp0(h)))
