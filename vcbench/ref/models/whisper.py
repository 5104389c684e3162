"""Whisper encoder, the content feature extractor (port of
``seedvc_tpu/models/whisper.py``).

Two mel convs (k=3, the second stride 2) with GELU, fixed sinusoidal position
embeddings stored as a parameter, pre-LN layers with biased attention
projections (k_proj bias-less) and GELU MLPs, a final LayerNorm. LayerNorm eps
is flax's default 1e-6, as in the JAX package. Attention is plain matmul +
softmax with fp32 logits, as the JAX einsum with fp32 accumulation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


@dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 1500


WHISPER_SMALL = WhisperEncoderConfig()


class WhisperAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.n_heads
        hd = D // H
        q = (self.q_proj(x) * hd ** -0.5).reshape(B, T, H, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, T, H, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, T, H, hd).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.self_attn = WhisperAttention(cfg.d_model, cfg.n_heads)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoid position table."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv_timescales = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32))
    scaled = torch.arange(length, dtype=torch.float32)[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig = WHISPER_SMALL):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Parameter(sinusoids(cfg.max_positions, cfg.d_model))
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", WhisperEncoderLayer(cfg))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, 3000, n_mels) whisper log-mel -> (B, 1500, d_model)."""
        h = F.gelu(self.conv1(mel.transpose(1, 2)))
        h = F.gelu(self.conv2(h)).transpose(1, 2)
        h = h + self.embed_positions[None, : h.shape[1]]
        for i in range(self.cfg.n_layers):
            h = getattr(self, f"layers_{i}")(h)
        return self.layer_norm(h)
