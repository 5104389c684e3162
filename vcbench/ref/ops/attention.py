"""Plain attention of the frozen reference: the materialised-logits twins of
the port's K1 and K3, on every device. The entry points keep the port's
names and signatures so the frozen modules call them unchanged."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
HEAD_DIM = 64


def _pair_swap(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (x1, x0, x3, x2, ...) on the last axis."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack((x2[..., 1], x2[..., 0]), dim=-1).reshape(x.shape)



def _masked_logits(q, k, lens):
    Tk, d = k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if lens is not None:
        mask = torch.arange(Tk, device=q.device)[None, :] < lens[:, None]
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s



def dit_attention_reference(q, k, v, lens=None):
    """Materialised-logits attention, fp32 softmax (post-RoPE inputs)."""
    p = torch.softmax(_masked_logits(q, k, lens), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)



def dit_attention_lse_reference(q, k, lens=None):
    """Row log-sum-exp (B, H, T) f32 of :func:`dit_attention_reference`'s
    masked logits (post-RoPE q, k): the statistics the f32 kernel writes for
    K1ᵇ (-1e30 where a batch row has no valid key)."""
    return torch.logsumexp(_masked_logits(q, k, lens), dim=-1)



def rope_scaled_reference(x, cos, sin, scale: float = 1.0):
    """Interleaved RoPE through the (T, d) cos / signed-sin caches in fp32,
    times ``scale``, rounded to x's dtype: the plain twin of K1's pre-pass
    (q with scale 2⁻³, k with 1)."""
    xf = x.float()
    return ((xf * cos + _pair_swap(xf) * sin) * scale).to(x.dtype)



def dit_attention_fused_reference(q, k, v, cos, sin, lens=None, q_rope=None):
    """Plain twin of K1: :func:`rope_scaled_reference` on q and k, then
    :func:`dit_attention_reference` (which scales the logits by 1/√d).
    cos/sin are k's (Tk, 64) tables; ``q_rope`` = (cos, sin) of q's rows,
    (Tq, 64), or None for the same tables as k's."""
    q_cos, q_sin = (cos, sin) if q_rope is None else q_rope
    return dit_attention_reference(rope_scaled_reference(q, q_cos, q_sin),
                                   rope_scaled_reference(k, cos, sin), v, lens)




def dit_attention_fused(q, k, v, cos, sin, lens=None, return_lse=False, q_rope=None):
    q_cos, q_sin = (cos, sin) if q_rope is None else q_rope
    out = dit_attention_fused_reference(q, k, v, cos, sin, lens, (q_cos, q_sin))
    if not return_lse:
        return out
    return out, dit_attention_lse_reference(rope_scaled_reference(q, q_cos, q_sin),
                                            rope_scaled_reference(k, cos, sin), lens)


def dit_attention(q, k, v, lens=None, return_lse=False):
    out = dit_attention_reference(q, k, v, lens)
    return (out, dit_attention_lse_reference(q, k, lens)) if return_lse else out


def dit_attention_fused_diff(q, k, v, cos, sin, lens=None):
    return dit_attention_fused_reference(q, k, v, cos, sin, lens)


def dit_attention_diff(q, k, v, lens=None):
    return dit_attention_reference(q, k, v, lens)
