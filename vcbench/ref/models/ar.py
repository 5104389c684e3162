"""v2's AR token-to-token transformer, plain: the full causal forward over
each row's whole sequence, in f32.

A decoder-only LM (768 wide, 12 layers, 12 query heads over 2 KV heads,
vocab 2049 = 2048 wide codes + EOS) over ``[sep ‖ cond ‖ sep ‖ prompt ‖
generated]`` with RoPE positions restarting at the second sep. The
parameters are named and ordered as the port's.

Departures from the port, and from the published model's decode: no KV
cache, no packed left-padded prefill and no CUDA graph; each row runs alone
on its own unpadded sequence; the grouped KV heads are repeated to the
query heads (query head h reads KV head h // 6) instead of contracted
against directly. :meth:`ARTransformer.teacher_forced` runs the whole
sequence with the generated tokens given (the benchmark's comparison:
logits, not sampled tokens); :func:`generate` samples a row token by token,
each step a full forward over everything so far (the CPU tests alone: its
cost grows with the square of the length). Sampling is the port's: the
repetition penalty on the first generated token, EOS suppressed for the
first 10 tokens, top-p on the pre-temperature logits, the exponential race
``argmax(probs / q)`` with the draws ``q`` given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.nn.layers import RMSNorm, rope_cache


@dataclass(frozen=True)
class ARConfig:
    dim: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_local_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 2304
    vocab_size: int = 2049
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096

    @property
    def eos(self) -> int:
        return self.vocab_size - 1


def apply_rope_at(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE in f32: x (S, H, D), freqs (S, D // 2, 2) at
    each row's own position."""
    xf = x.float().reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    cos, sin = freqs[:, None, :, 0], freqs[:, None, :, 1]
    out = torch.stack([xf[..., 0] * cos - xf[..., 1] * sin,
                       xf[..., 1] * cos + xf[..., 0] * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class ARAttention(nn.Module):
    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.wqkv = nn.Linear(c.dim, (c.n_head + 2 * c.n_local_heads) * c.head_dim, bias=False)
        self.wo = nn.Linear(c.n_head * c.head_dim, c.dim, bias=False)

    def forward(self, x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        """x: (S, D) one row; causal over its S positions."""
        c = self.cfg
        S = x.shape[0]
        H, G, hd = c.n_head, c.n_local_heads, c.head_dim
        q, k, v = self.wqkv(x).split([H * hd, G * hd, G * hd], dim=-1)
        q = apply_rope_at(q.reshape(S, H, hd), freqs)
        k = apply_rope_at(k.reshape(S, G, hd), freqs).repeat_interleave(H // G, dim=1)
        v = v.reshape(S, G, hd).repeat_interleave(H // G, dim=1)
        logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * hd ** -0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("hqk,khd->qhd", probs, v)
        return self.wo(out.reshape(S, H * hd))


class ARBlock(nn.Module):
    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.attention = ARAttention(cfg)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.feed_forward_w1 = nn.Linear(cfg.dim, cfg.intermediate_size, bias=False)
        self.feed_forward_w3 = nn.Linear(cfg.dim, cfg.intermediate_size, bias=False)
        self.feed_forward_w2 = nn.Linear(cfg.intermediate_size, cfg.dim, bias=False)

    def forward(self, x, freqs):
        x = x + self.attention(self.attention_norm(x), freqs)
        h = self.ffn_norm(x)
        return x + self.feed_forward_w2(F.silu(self.feed_forward_w1(h)) * self.feed_forward_w3(h))


class ARTransformer(nn.Module):
    def __init__(self, cfg: ARConfig = ARConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        for i in range(cfg.n_layer):
            self.add_module(f"layers_{i}", ARBlock(cfg))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.output = nn.Linear(cfg.dim, cfg.vocab_size, bias=False)
        self.sep_token_emb = nn.Parameter(torch.zeros(cfg.dim))

    def sequence(self, cond_emb: torch.Tensor, prompt: torch.Tensor,
                 generated: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One row's embeddings (S, D) and positions (S,): cond_emb (C, D)
        regulated narrow tokens; prompt (P,) and generated (N,) wide tokens."""
        dev = cond_emb.device
        sep = self.sep_token_emb.to(cond_emb.dtype)[None]
        toks = torch.cat([prompt, generated]).long().to(dev)
        emb = torch.cat([sep, cond_emb, sep, self.embeddings(toks).to(cond_emb.dtype)])
        C = cond_emb.shape[0]
        pos = torch.cat([torch.arange(C + 1, device=dev), torch.arange(len(toks) + 1, device=dev)])
        return emb, pos

    def forward(self, emb: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One row: emb (S, D), pos (S,) -> logits (S, vocab), causal."""
        c = self.cfg
        table = torch.from_numpy(rope_cache(c.max_seq_len, c.head_dim, c.rope_base)).to(emb.device)
        freqs = table[torch.clamp(pos, max=c.max_seq_len - 1)]
        x = emb
        for i in range(c.n_layer):
            x = getattr(self, f"layers_{i}")(x, freqs)
        return self.output(self.norm(x))

    def teacher_forced(self, cond_emb, prompt, generated) -> torch.Tensor:
        """The logits (N, vocab) that predicted each of the N generated
        tokens: from the last prompt position (the second sep when there is
        no prompt) to the second-last generated token."""
        N = len(generated)
        emb, pos = self.sequence(cond_emb, prompt, generated[: max(N - 1, 0)])
        start = cond_emb.shape[0] + 1 + len(prompt)
        return self(emb, pos)[start: start + N]


def token_scores(logits, penal_mask, q, *, temperature=0.7, top_p=0.7, repetition_penalty=1.5,
                 suppress_eos=False, eos: int = 2048) -> torch.Tensor:
    """``probs / q`` over the last axis, whose argmax is the sampled token."""
    logits = logits.float()
    penal = torch.where(logits < 0, logits * repetition_penalty, logits / repetition_penalty)
    logits = torch.where(penal_mask, penal, logits)
    if suppress_eos:
        logits = logits.clone()
        logits[..., eos] = -torch.inf
    neg_sorted, order = torch.sort(-logits, dim=-1, stable=True)
    cum = torch.cumsum(torch.softmax(-neg_sorted, dim=-1), dim=-1)
    remove_sorted = cum > top_p
    remove_sorted[..., 0] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, order, remove_sorted)
    logits = logits.masked_fill(remove, -torch.inf)
    return torch.softmax(logits / max(temperature, 1e-5), dim=-1) / q


@torch.no_grad()
def generate(model: ARTransformer, cond_emb: torch.Tensor, prompt: torch.Tensor,
             draws: torch.Tensor, row: int, max_new: int, cap: int | None = None, *,
             temperature=0.7, top_p=0.7, repetition_penalty=1.5) -> np.ndarray:
    """Row ``row``'s generated wide tokens: draws (max_new, B, vocab), row
    s for token s; stops at EOS (not kept), at ``cap`` tokens or at
    ``max_new``."""
    eos, V = model.cfg.eos, model.cfg.vocab_size
    limit = max_new if cap is None else min(cap, max_new)
    out: list[int] = []
    for s in range(max_new):
        emb, pos = model.sequence(cond_emb, prompt, torch.tensor(out, dtype=torch.long))
        logits = model(emb, pos)[-1]
        penal = torch.zeros(V, dtype=torch.bool, device=logits.device)
        if out:
            penal[out[0]] = True
        tok = int(torch.argmax(token_scores(
            logits, penal, draws[s, row].to(logits.device), temperature=temperature,
            top_p=top_p, repetition_penalty=repetition_penalty, suppress_eos=s < 10, eos=eos)))
        if tok == eos:
            break
        out.append(tok)
        if len(out) >= limit:
            break
    return np.array(out, np.int64)
