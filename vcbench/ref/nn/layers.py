"""Core transformer building blocks, channels-last (B, T, C).

Port of ``seedvc_tpu/nn/layers.py``: RMSNorm in fp32, interleaved-pair RoPE,
fused-QKV attention, SwiGLU FFN, 2-parameter adaptive RMS norm, sinusoidal
timestep embedder with scale 1000. Submodule names follow the flax ones,
as the port's do.

``Attention`` follows the JAX package's branch rule: K1
(``ops.attention.dit_attention_fused``), K3 (``ops.attention.dit_attention``)
or the einsum path; in grad mode K1 and K3 run through their autograd
Functions, whose backward is K1ᵇ. The kernels' wrappers send CPU tensors to
their plain twins, so the branch taken does not depend on the device.

Compute types follow flax's: :class:`Dense` computes in its input's dtype
(flax ``Dense(dtype=x.dtype)``), and mixed bf16 / f32 operands promote as
jnp's do, which is what the trainer's bf16 compute with f32 weights relies on.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.ops.attention import (dit_attention, dit_attention_diff,
                                       dit_attention_fused, dit_attention_fused_diff)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype, casting its weights
    to it: flax's ``nn.Dense(dtype=x.dtype)``, which the JAX modules use
    wherever a layer's compute type follows the activations. With the
    weights already in the input's dtype it is ``nn.Linear``. Under the
    trainer's bf16 compute (f32 master weights, bf16 activations) the mixed
    types promote as the JAX package's do."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class RMSNorm(nn.Module):
    """RMS norm computed in fp32, cast back, then scaled."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm with weight/bias projected from a conditioning embedding.
    Unconditioned (the time-as-token trunks, which pass ``emb=None``) it is
    the plain norm and owns no ``project_layer``, as the flax module."""

    def __init__(self, dim: int, eps: float = 1e-5, conditioned: bool = True):
        super().__init__()
        self.norm = RMSNorm(dim, eps)
        self.project_layer = Dense(dim, 2 * dim) if conditioned else None
        self.unused_tree_entries = () if conditioned else ("project_layer",)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor]) -> torch.Tensor:
        if emb is None:
            return self.norm(x)
        weight, bias = self.project_layer(emb.to(x.dtype)).chunk(2, dim=-1)
        return weight * self.norm(x) + bias


def _rope_freqs(head_dim: int, base: float) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim))


def rope_cache(seq_len: int, head_dim: int, base: float = 10000.0) -> np.ndarray:
    """(seq_len, head_dim//2, 2) cos/sin cache."""
    ang = np.outer(np.arange(seq_len), _rope_freqs(head_dim, base))
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def rope_full_cache(seq_len: int, head_dim: int,
                    base: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """(T, head_dim) caches: cos_full[:, 2i] = cos_full[:, 2i+1] = cos(t f_i),
    sin_signed[:, 2i] = -sin(t f_i), sin_signed[:, 2i+1] = +sin(t f_i), so that
    ``x*cos_full + pair_swap(x)*sin_signed`` is interleaved-pair RoPE."""
    ang = np.outer(np.arange(seq_len), _rope_freqs(head_dim, base))
    cos_full = np.repeat(np.cos(ang), 2, axis=1)
    sin_signed = np.repeat(np.sin(ang), 2, axis=1)
    sin_signed[:, 0::2] *= -1.0
    return cos_full.astype(np.float32), sin_signed.astype(np.float32)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs in fp32. x: (B, T, H, D); freqs: (T, D//2, 2)."""
    xf = x.float().reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    cos = freqs[None, :, None, :, 0]
    sin = freqs[None, :, None, :, 1]
    out = torch.stack([xf[..., 0] * cos - xf[..., 1] * sin,
                       xf[..., 1] * cos + xf[..., 0] * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class Attention(nn.Module):
    """Fused-QKV multi-head attention with grouped KV heads and key padding.

    With ``use_flash``: K1's plain twin (RoPE from the full tables) when the
    heads are not grouped and ``rope_full`` is given, else RoPE here and
    K3's twin; when grad mode is on and q/k/v require grad, through the
    twins' autograd path. Otherwise the einsum path: fp32 logits and
    softmax, probabilities cast to the input type before P.V.
    """

    def __init__(self, dim: int, n_head: int, n_local_heads: int | None = None,
                 head_dim: int | None = None, use_flash: bool = False):
        super().__init__()
        self.n_head = n_head
        self.n_kv = n_local_heads or n_head
        self.head_dim = head_dim or dim // n_head
        self.use_flash = use_flash
        self.wqkv = Dense(dim, (n_head + 2 * self.n_kv) * self.head_dim, bias=False)
        self.wo = Dense(n_head * self.head_dim, dim, bias=False)

    def forward(self, x: torch.Tensor, freqs: torch.Tensor, lens: Optional[torch.Tensor],
                rope_full: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """x: (B, T, dim); freqs: (T, head_dim//2, 2) f32 from ``rope_cache``;
        lens: (B,) int32 valid key counts or None; rope_full: (T, head_dim)
        f32 cos/sin from ``rope_full_cache``, or None."""
        B, T, _ = x.shape
        H, Hkv, hd = self.n_head, self.n_kv, self.head_dim
        q, k, v = self.wqkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        train = torch.is_grad_enabled() and q.requires_grad
        if self.use_flash and Hkv == H and rope_full is not None:
            q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2).contiguous() for t in (q, k, v))
            fused = dit_attention_fused_diff if train else dit_attention_fused
            out = fused(q, k, v, *rope_full, lens).transpose(1, 2)
            return self.wo(out.reshape(B, T, H * hd))

        q = apply_rope(q.reshape(B, T, H, hd), freqs)
        k = apply_rope(k.reshape(B, T, Hkv, hd), freqs)
        v = v.reshape(B, T, Hkv, hd)
        if Hkv != H:  # [kv0, kv0, kv1, kv1, ...], as jnp.repeat on the head axis
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        if self.use_flash:
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            out = (dit_attention_diff if train else dit_attention)(q, k, v, lens).transpose(1, 2)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
            if lens is not None:
                valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
                logits = logits.masked_fill(~valid[:, None, None, :],
                                            torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        return self.wo(out.reshape(B, T, H * hd))


class FeedForward(nn.Module):
    """SwiGLU: w2(silu(w1 x) * w3 x)."""

    def __init__(self, dim: int, intermediate: int):
        super().__init__()
        self.w1 = Dense(dim, intermediate, bias=False)
        self.w3 = Dense(dim, intermediate, bias=False)
        self.w2 = Dense(intermediate, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def ffn_intermediate_size(dim: int) -> int:
    """gpt-fast default intermediate size."""
    hidden = int(2 * (4 * dim) / 3)
    return -(-hidden // 256) * 256


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding (scale 1000) -> MLP(SiLU)."""

    def __init__(self, hidden_size: int, freq_embed_size: int = 256):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.mlp0 = nn.Linear(freq_embed_size, hidden_size)
        self.mlp2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.freq_embed_size // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = 1000.0 * t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        emb = emb.to(self.mlp0.weight.dtype)
        return self.mlp2(F.silu(self.mlp0(emb)))
