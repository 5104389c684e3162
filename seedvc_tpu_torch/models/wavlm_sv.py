"""WavLM speaker-verification x-vector extractor for SECS scoring (port of
``seedvc_tpu/models/wavlm_sv.py``, HF ``WavLMForXVector``), computed in f32.

- conv feature encoder in "group" norm mode: conv 0, GroupNorm(C groups) and
  exact GELU, then 6 norm-free convs (all bias-free),
- feature projection (LayerNorm -> Linear), the grouped positional conv
  (kernel 128, 16 groups, padding (64, 63)) and a LayerNorm,
- post-LN transformer layers with a gated relative position bias: T5-style
  buckets (``relative_position_buckets``, host numpy in f64 as in the JAX
  module) into a shared embedding, scaled per layer by a gate taken from the
  raw per-head hidden states,
- x-vector head: softmax-weighted sum of all hidden states, a projector, 5
  TDNN convs, mean + std (ddof 1) statistics pooling, a Linear to 512.

``lengths`` gives the true sample counts of a zero-padded batch: the wave is
normalised over its true length, conv 0's GroupNorm takes its statistics over
the frames of the true length, the padded features are zeroed before the
positional conv, padded keys get a -1e30 bias and the pooling runs over the
TDNN's true frames, so a padded forward equals the unpadded one. The JAX
module's GroupNorm takes its statistics over the padded frames too, so its
padded forward does not (ROADMAP queue 3). Attention is plain PyTorch: the
JAX module computes it with ``einsum`` and no Pallas kernel. Public layout:
wave (B, T) at 16 kHz in, (B, xvector_dim) out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class WavLMSVConfig:
    conv_dim: int = 512
    conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    num_buckets: int = 320
    max_distance: int = 800
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    tdnn_dims: Sequence[int] = (512, 512, 512, 512, 1500)
    tdnn_kernels: Sequence[int] = (5, 3, 3, 1, 1)
    tdnn_dilations: Sequence[int] = (1, 2, 3, 1, 1)
    xvector_dim: int = 512
    layer_norm_eps: float = 1e-5


WAVLM_BASE_PLUS_SV = WavLMSVConfig()  # microsoft/wavlm-base-plus-sv


def relative_position_buckets(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5-style bidirectional buckets (T, T) int64 of ``mem - ctx``
    (``modeling_wavlm.py:253-271``), on the host in f64."""
    nb = num_buckets // 2
    rel = np.arange(T)[None, :] - np.arange(T)[:, None]
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    with np.errstate(divide="ignore"):
        large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / math.log(max_distance / max_exact) * (nb - max_exact)
    large = np.minimum((max_exact + large).astype(np.int64), nb - 1)
    return buckets + np.where(is_small, rel, large)


class WavLMAttention(nn.Module):
    def __init__(self, c: WavLMSVConfig):
        super().__init__()
        self.c = c
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, c.n_heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(c.d_model // c.n_heads, 8)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(c.d_model, c.d_model))

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, d_model), position_bias (H, T, T), key_bias (B, 1, 1, T)."""
        c = self.c
        B, T, _ = x.shape
        H, hd = c.n_heads, c.d_model // c.n_heads
        # the gate comes from the raw per-head hidden states, not from q
        proj = self.gru_rel_pos_linear(x.reshape(B, T, H, hd).transpose(1, 2))
        gate_a, gate_b = torch.sigmoid(proj.reshape(B, H, T, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0  # (B, H, T, 1)

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q = heads(self.q_proj(x) * hd ** -0.5)
        logits = q @ heads(self.k_proj(x)).transpose(-1, -2) + gate * position_bias[None]
        if key_bias is not None:
            logits = logits + key_bias
        attn = torch.softmax(logits, dim=-1) @ heads(self.v_proj(x))
        return self.out_proj(attn.transpose(1, 2).reshape(B, T, c.d_model))


class WavLMLayer(nn.Module):
    """Post-LN encoder layer (the base checkpoints' ``do_stable_layer_norm=False``)."""

    def __init__(self, c: WavLMSVConfig):
        super().__init__()
        self.attention = WavLMAttention(c)
        self.layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.intermediate_dense = nn.Linear(c.d_model, c.ffn_dim)
        self.output_dense = nn.Linear(c.ffn_dim, c.d_model)
        self.final_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)

    def forward(self, x, position_bias, key_bias=None):
        x = self.layer_norm(x + self.attention(x, position_bias, key_bias))
        x = x + self.output_dense(F.gelu(self.intermediate_dense(x)))
        return self.final_layer_norm(x)


class WavLMSV(nn.Module):
    """WavLMForXVector: wave (B, T) at 16 kHz -> x-vectors (B, xvector_dim)."""

    def __init__(self, cfg: WavLMSVConfig = WAVLM_BASE_PLUS_SV):
        super().__init__()
        self.cfg = c = cfg
        in_ch = 1
        for i, (k, s) in enumerate(zip(c.conv_kernels, c.conv_strides)):
            self.add_module(f"conv_layers_{i}", nn.Conv1d(in_ch, c.conv_dim, k, stride=s,
                                                          bias=False))
            in_ch = c.conv_dim
        self.conv_group_norm = nn.GroupNorm(c.conv_dim, c.conv_dim, eps=c.layer_norm_eps)
        self.fp_layer_norm = nn.LayerNorm(c.conv_dim, eps=c.layer_norm_eps)
        self.fp_projection = nn.Linear(c.conv_dim, c.d_model)
        self.pos_conv = nn.Conv1d(c.d_model, c.d_model, c.pos_conv_kernel,
                                  groups=c.pos_conv_groups)
        self.encoder_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.rel_attn_embed = nn.Parameter(0.02 * torch.randn(c.num_buckets, c.n_heads))
        for i in range(c.n_layers):
            self.add_module(f"layers_{i}", WavLMLayer(c))
        self.layer_weights = nn.Parameter(torch.full((c.n_layers + 1,), 1.0 / (c.n_layers + 1)))
        self.projector = nn.Linear(c.d_model, c.tdnn_dims[0])
        in_ch = c.tdnn_dims[0]
        for i, (dim, k, d) in enumerate(zip(c.tdnn_dims, c.tdnn_kernels, c.tdnn_dilations)):
            self.add_module(f"tdnn_{i}", nn.Conv1d(in_ch, dim, k, dilation=d))
            in_ch = dim
        self.feature_extractor = nn.Linear(2 * in_ch, c.xvector_dim)

    def _group_norm(self, h: torch.Tensor, n: Optional[torch.Tensor]) -> torch.Tensor:
        """Conv 0's GroupNorm (one channel a group) on (B, C, T); with ``n``
        (B,) its statistics come from each row's first n frames."""
        gn = self.conv_group_norm
        if n is None:
            return gn(h)
        m = (torch.arange(h.shape[-1], device=h.device)[None, :] < n[:, None])[:, None]
        m = m.to(h.dtype)
        cnt = n.to(h.dtype)[:, None, None]
        mean = (h * m).sum(-1, keepdim=True) / cnt
        var = (((h - mean) * m) ** 2).sum(-1, keepdim=True) / cnt
        return (h - mean) * torch.rsqrt(var + gn.eps) * gn.weight[:, None] + gn.bias[:, None]

    def forward(self, wave: torch.Tensor, normalize: bool = True,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lengths`` (B,) int: true sample counts of a zero-padded ``wave``
        (HF ``attention_mask`` semantics), or None when every sample is valid."""
        c = self.cfg
        smask = None
        if lengths is not None:
            smask = (torch.arange(wave.shape[1], device=wave.device)[None]
                     < lengths[:, None]).to(wave.dtype)
        if normalize:  # HF Wav2Vec2FeatureExtractor's do_normalize, before padding
            if smask is None:
                mean = wave.mean(dim=-1, keepdim=True)
                var = wave.var(dim=-1, keepdim=True, unbiased=False)
                wave = (wave - mean) / torch.sqrt(var + 1e-7)
            else:
                n = lengths.to(wave.dtype)[:, None]
                mean = (wave * smask).sum(-1, keepdim=True) / n
                var = (((wave - mean) * smask) ** 2).sum(-1, keepdim=True) / n
                wave = (wave - mean) / torch.sqrt(var + 1e-7) * smask
        elif smask is not None:
            wave = wave * smask

        # feature lengths after each conv (HF _get_feat_extract_output_lengths)
        lens = [lengths]
        for k, s in zip(c.conv_kernels, c.conv_strides):
            lens.append(None if lengths is None else (lens[-1] - k) // s + 1)
        h = wave[:, None]
        for i in range(len(c.conv_kernels)):
            h = getattr(self, f"conv_layers_{i}")(h)
            if i == 0:
                h = self._group_norm(h, lens[1])
            h = F.gelu(h)
        h = self.fp_projection(self.fp_layer_norm(h.transpose(1, 2)))  # (B, T', d_model)

        feat_len, key_bias = lens[-1], None
        if feat_len is not None:
            fmask = torch.arange(h.shape[1], device=h.device)[None] < feat_len[:, None]
            h = h * fmask[..., None].to(h.dtype)  # zeroed once, before pos_conv
            key_bias = torch.where(fmask, 0.0, -1e30).to(h.dtype)[:, None, None, :]

        half = c.pos_conv_kernel // 2
        pos = self.pos_conv(F.pad(h.transpose(1, 2), (half, half - 1)))
        h = self.encoder_layer_norm(h + F.gelu(pos).transpose(1, 2))

        T = h.shape[1]
        buckets = torch.from_numpy(relative_position_buckets(T, c.num_buckets, c.max_distance))
        position_bias = self.rel_attn_embed[buckets.to(h.device)].permute(2, 0, 1)  # (H, T, T)
        w = torch.softmax(self.layer_weights, dim=0)
        acc = w[0] * h
        for i in range(c.n_layers):
            h = getattr(self, f"layers_{i}")(h, position_bias, key_bias)
            acc = acc + w[i + 1] * h

        h = self.projector(acc).transpose(1, 2)  # (B, C, T')
        for i in range(len(c.tdnn_dims)):
            h = F.relu(getattr(self, f"tdnn_{i}")(h))
        # mean + std (ddof 1) pooling, over the TDNN's true frames with lengths
        if feat_len is None:
            mean, std = h.mean(dim=-1), h.std(dim=-1)
        else:
            tdnn_len = feat_len - sum((k - 1) * d for k, d in zip(c.tdnn_kernels,
                                                                  c.tdnn_dilations))
            tmask = (torch.arange(h.shape[-1], device=h.device)[None]
                     < tdnn_len[:, None])[:, None].to(h.dtype)
            n = tdnn_len.to(h.dtype)[:, None]
            mean = (h * tmask).sum(-1) / n
            std = torch.sqrt((((h - mean[..., None]) * tmask) ** 2).sum(-1) / (n - 1.0))
        return self.feature_extractor(torch.cat([mean, std], dim=-1))
