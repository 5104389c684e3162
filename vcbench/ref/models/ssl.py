"""wav2vec2 / XLS-R / HuBERT SSL content encoders (port of
``seedvc_tpu/models/ssl.py``).

One architecture family: a conv feature extractor (7 convs, 320x
downsample) in "layer" norm mode (each conv with a bias, then a LayerNorm over
channels and exact GELU), a feature projection (LayerNorm -> Linear), a
grouped positional conv embedding (kernel 128, 16 groups, padding (64, 63)),
pre-LN transformer layers and an optional final LayerNorm (off when the
encoder is truncated, as the reference's ``encoder.layer_norm = Identity()``).

The wave is normalised per utterance (zero mean, unit population variance)
over the whole padded window, zeros included, as the JAX module does.
Attention is plain PyTorch: the JAX module computes it with ``einsum`` and no
Pallas kernel. Public layout: wave (B, T) at 16 kHz in, (B, T // 320,
d_model) at 50 Hz out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SSLConfig:
    conv_dim: int = 512
    conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    d_model: int = 1024
    n_layers: int = 12          # after truncation (XLSR: output_layer 12)
    n_heads: int = 16
    ffn_dim: int = 4096
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    apply_final_norm: bool = False
    layer_norm_eps: float = 1e-5


XLSR_300M_L12 = SSLConfig()  # facebook/wav2vec2-xls-r-300m truncated at layer 12
HUBERT_LARGE_L18 = SSLConfig(n_layers=18, apply_final_norm=False)


class SSLEncoderLayer(nn.Module):
    """Pre-LN layer: the query scaled before the product, f32 logits and
    softmax, the probabilities cast to the input type before P.V."""

    def __init__(self, c: SSLConfig):
        super().__init__()
        self.c = c
        self.layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.q_proj = nn.Linear(c.d_model, c.d_model)
        self.k_proj = nn.Linear(c.d_model, c.d_model)
        self.v_proj = nn.Linear(c.d_model, c.d_model)
        self.out_proj = nn.Linear(c.d_model, c.d_model)
        self.final_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.intermediate_dense = nn.Linear(c.d_model, c.ffn_dim)
        self.output_dense = nn.Linear(c.ffn_dim, c.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        B, T, _ = x.shape
        hd = c.d_model // c.n_heads
        h = self.layer_norm(x)
        q = (self.q_proj(h) * hd ** -0.5).reshape(B, T, c.n_heads, hd).transpose(1, 2)
        k = self.k_proj(h).reshape(B, T, c.n_heads, hd).transpose(1, 2)
        v = self.v_proj(h).reshape(B, T, c.n_heads, hd).transpose(1, 2)
        probs = torch.softmax(q.float() @ k.float().transpose(-1, -2), dim=-1).to(x.dtype)
        attn = (probs.float() @ v.float()).to(x.dtype).transpose(1, 2).reshape(B, T, c.d_model)
        x = x + self.out_proj(attn)
        h = F.gelu(self.intermediate_dense(self.final_layer_norm(x)))
        return x + self.output_dense(h)


class SSLEncoder(nn.Module):
    def __init__(self, cfg: SSLConfig = XLSR_300M_L12):
        super().__init__()
        self.cfg = c = cfg
        in_ch = 1
        for i, (k, s) in enumerate(zip(c.conv_kernels, c.conv_strides)):
            self.add_module(f"conv_layers_{i}", nn.Conv1d(in_ch, c.conv_dim, k, stride=s))
            self.add_module(f"conv_ln_{i}", nn.LayerNorm(c.conv_dim, eps=c.layer_norm_eps))
            in_ch = c.conv_dim
        self.fp_layer_norm = nn.LayerNorm(c.conv_dim, eps=c.layer_norm_eps)
        self.fp_projection = nn.Linear(c.conv_dim, c.d_model)
        self.pos_conv = nn.Conv1d(c.d_model, c.d_model, c.pos_conv_kernel,
                                  groups=c.pos_conv_groups)
        for i in range(c.n_layers):
            self.add_module(f"layers_{i}", SSLEncoderLayer(c))
        if c.apply_final_norm:
            self.encoder_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)

    def forward(self, wave: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """wave: (B, T) 16 kHz -> (B, T // 320, d_model)."""
        c = self.cfg
        if normalize:
            mean = wave.mean(dim=-1, keepdim=True)
            var = wave.var(dim=-1, keepdim=True, unbiased=False)
            wave = (wave - mean) / torch.sqrt(var + 1e-7)
        h = wave[:, None, :]  # (B, 1, T)
        for i in range(len(c.conv_kernels)):
            h = getattr(self, f"conv_layers_{i}")(h).transpose(1, 2)
            h = F.gelu(getattr(self, f"conv_ln_{i}")(h)).transpose(1, 2)
        h = self.fp_projection(self.fp_layer_norm(h.transpose(1, 2)))  # (B, T', d_model)
        # torch pads 64 both sides and drops the last output (even kernel):
        # the effective padding is (64, 63)
        half = c.pos_conv_kernel // 2
        pos = self.pos_conv(F.pad(h.transpose(1, 2), (half, half - 1)))
        h = h + F.gelu(pos).transpose(1, 2)
        for i in range(c.n_layers):
            h = getattr(self, f"layers_{i}")(h)
        if c.apply_final_norm:
            h = self.encoder_layer_norm(h)
        return h
