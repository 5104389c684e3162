"""v2 AR token-to-token transformer and its batched decode (port of
``seedvc_tpu/models/ar.py``).

A decoder-only LM (768 wide, 12 layers, 12 query heads over 2 KV heads,
vocab 2049 = 2048 wide codes + EOS) over ``[sep ‖ cond ‖ sep ‖ prompt]``
with RoPE positions restarting at the second sep and global KV slots.
Attention contracts grouped query heads against the KV heads directly (no
repeat of the cache), with f32 logits and softmax.

:class:`ARGenerator` is the counterpart of the JAX ``make_generate_fn``:
rows are left-padded inside one packed prefill so every row's last token sits
on the same cache slot, then each decode step writes all rows at one kv slot
(``min_key`` keeps pad slots out), samples with a repetition penalty, EOS
suppression, top-p and temperature (the knobs are runtime arguments), and
stops when every row has emitted EOS, or reached its own token cap when
one is given, or after ``max_new_tokens``. The
multinomial draw is the exponential race ``argmax(probs / q)``, and the
draws ``q`` are an argument. On cuda the decode step is captured once as a
CUDA graph and replayed once a token; the host reads ``all(done)`` every
``CHECK_EVERY`` replays, and the steps after every row is done write
nothing, so the result is the JAX early exit's.

On cuda the decode step's transformer is :meth:`ARTransformer.decode_chain`,
five hand-written kernels a layer and one for the head
(``ops/ar_decode.py``); on the CPU it is the plain
:meth:`ARTransformer.decode_step_reference`, the kernels' twin. Prefill and
the full-sequence forward (training) stay plain PyTorch: their products have
hundreds to thousands of rows, not the decode's one to a few.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from seedvc_tpu_torch.nn.layers import RMSNorm, rope_cache
from seedvc_tpu_torch.ops import ar_decode, launches
from seedvc_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group
from seedvc_tpu_torch.parallel.sharding import TensorParallel, TPSplit

# replays between the host's reads of all(done)
CHECK_EVERY = 32


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


def rope_rows(freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D // 2, 2) cos/sin -> (cos_full, sin_signed), each (B, S, 1, D):
    cos_full[2i] = cos_full[2i+1] = cos_i, sin_signed[2i] = -sin_i,
    sin_signed[2i+1] = sin_i."""
    cos, sin = freqs[..., 0], freqs[..., 1]
    cos_full = torch.stack([cos, cos], dim=-1).flatten(-2)[:, :, None]
    sin_signed = torch.stack([-sin, sin], dim=-1).flatten(-2)[:, :, None]
    return cos_full, sin_signed


def apply_rope_batched(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Interleaved-pair RoPE in f32 with per-row positions: x (B, S, H, D),
    ``rope`` from :func:`rope_rows`. ``x*cos_full + pair_swap(x)*sin_signed``
    rounds as ``(x0 cos - x1 sin, x1 cos + x0 sin)`` does."""
    xf = x.float()
    swapped = xf.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return (xf * rope[0] + swapped * rope[1]).to(x.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 output (accumulated in f32 either way)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


class ARAttention(TensorParallel, nn.Module):
    """Grouped-query attention of the AR. Tensor parallel: this rank's query
    heads and their KV heads (rows of ``wqkv``) and those heads' columns of
    ``wo``, summed over the ``model`` group (the full-sequence training
    pass; the decode's caches hold every head)."""

    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.n_head, self.n_kv = c.n_head, c.n_local_heads
        self.wqkv = nn.Linear(c.dim, (c.n_head + 2 * c.n_local_heads) * c.head_dim, bias=False)
        self.wo = nn.Linear(c.n_head * c.head_dim, c.dim, bias=False)

    def tp_splits(self) -> dict:
        H, G, hd = self.n_head, self.n_kv, self.cfg.head_dim
        return {"wqkv.weight": TPSplit(0, (H * hd, G * hd, G * hd)),
                "wo.weight": TPSplit(1, (H * hd,))}

    def tp_divides(self, n: int) -> bool:
        return self.n_head % n == 0 and self.n_kv % n == 0

    def _tp_local(self, n: int) -> None:
        self.n_head //= n
        self.n_kv //= n

    def forward(self, x, rope, masked, k_cache=None, v_cache=None, write_pos=None):
        """x: (B, S, D); rope: :func:`rope_rows` of the positions; masked:
        (B, S, K) bool, True where a key is excluded.

        Without caches, the keys are the S positions themselves. With caches
        (B, G, max_seq, hd) and no ``write_pos`` (prefill), this step's k/v
        fill slots [0, S) and the keys are those S slots. With ``write_pos``
        (a 0-d device tensor; decode, S = 1), k/v go to that slot, clamped to
        the last one as the JAX ``dynamic_update_slice`` clamps, and the keys
        are the whole cache."""
        B, S, _ = x.shape
        H, G, hd = self.n_head, self.n_kv, self.cfg.head_dim
        R = H // G
        x = copy_to_group(x, self.tp_group)
        qk, v = self.wqkv(x).split([(H + G) * hd, G * hd], dim=-1)
        qk = apply_rope_batched(qk.unflatten(-1, (H + G, hd)), rope)  # q and k in one pass
        q, k = qk[:, :, :H], qk[:, :, H:].transpose(1, 2)
        v = v.reshape(B, S, G, hd).transpose(1, 2)
        if k_cache is None:
            k_all, v_all = k, v
        elif write_pos is None:
            k_cache[:, :, :S] = k
            v_cache[:, :, :S] = v
            k_all, v_all = k, v
        else:
            slot = torch.clamp(write_pos, max=k_cache.shape[2] - 1).reshape(1)
            k_cache.index_copy_(2, slot, k)
            v_cache.index_copy_(2, slot, v)
            k_all, v_all = k_cache, v_cache
        K = k_all.shape[2]
        # query head h = g * R + r reads KV head g
        qg = q.reshape(B, S, G, R, hd).permute(0, 2, 3, 1, 4).reshape(B * G, R * S, hd)
        logits = _bmm_f32(qg, k_all.reshape(B * G, K, hd).transpose(1, 2)) * hd ** -0.5
        logits = logits.reshape(B, G, R, S, K).masked_fill(
            masked[:, None, None], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype).reshape(B * G, R * S, K)
        out = torch.bmm(probs, v_all.reshape(B * G, K, hd))
        out = out.reshape(B, G, R, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
        return reduce_from_group(self.wo(out), self.tp_group)


class ARBlock(nn.Module):
    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.attention = ARAttention(cfg)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.feed_forward_w1 = nn.Linear(cfg.dim, cfg.intermediate_size, bias=False)
        self.feed_forward_w3 = nn.Linear(cfg.dim, cfg.intermediate_size, bias=False)
        self.feed_forward_w2 = nn.Linear(cfg.intermediate_size, cfg.dim, bias=False)

    def forward(self, x, rope, masked, k_cache=None, v_cache=None, write_pos=None):
        x = x + self.attention(self.attention_norm(x), rope, masked, k_cache, v_cache, write_pos)
        h = self.ffn_norm(x)
        return x + self.feed_forward_w2(F.silu(self.feed_forward_w1(h)) * self.feed_forward_w3(h))


class ARTransformer(nn.Module):
    """KV caches are (n_layer, B, n_local_heads, max_seq_len, head_dim)
    tensors (:meth:`new_caches`) that prefill and decode fill in place."""

    def __init__(self, cfg: ARConfig = ARConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        for i in range(cfg.n_layer):
            self.add_module(f"layers_{i}", ARBlock(cfg))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.output = nn.Linear(cfg.dim, cfg.vocab_size, bias=False)
        # N(0, 1), as the JAX module initialises it: a zero sep token stays 0
        # through every layer (no biases), where each RMSNorm's gradient is
        # rsqrt(eps), so training from it overflows the gradient
        self.sep_token_emb = nn.Parameter(torch.randn(cfg.dim))
        self.fsdp_whole = ("sep_token_emb",)  # read by callers, outside forward
        self._rope: dict = {}

    def rope_table(self, device) -> torch.Tensor:
        """(max_seq_len, hd // 2, 2) f32 cos/sin, made once per device."""
        c = self.cfg
        table = self._rope.get(device)
        if table is None:
            table = torch.from_numpy(rope_cache(c.max_seq_len, c.head_dim, c.rope_base)).to(
                device)
            self._rope[device] = table
        return table

    def rope(self, input_pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, S) positions -> :func:`rope_rows` of their (B, S, hd // 2, 2)
        cos/sin, the positions clamped to the table as the JAX gather clamps."""
        table = self.rope_table(input_pos.device)
        return rope_rows(table[torch.clamp(input_pos, max=self.cfg.max_seq_len - 1)])

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embeddings(tokens)

    def new_caches(self, B: int, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        shape = (c.n_layer, B, c.n_local_heads, c.max_seq_len, c.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _layers(self):
        return (getattr(self, f"layers_{i}") for i in range(self.cfg.n_layer))

    def forward(self, emb_seq, input_pos, attn_mask):
        """Full-sequence forward: emb_seq (B, S, D); input_pos (B, S);
        attn_mask (B, 1, S, S) bool. Returns logits (B, S, vocab)."""
        rope, masked = self.rope(input_pos), ~attn_mask[:, 0]
        x = emb_seq
        for blk in self._layers():
            x = blk(x, rope, masked)
        return self.output(self.norm(x))

    def prefill(self, emb_seq, input_pos, attn_mask, k_caches, v_caches):
        """The full-sequence forward that also fills cache slots [0, S).
        Returns the last position's logits (B, vocab)."""
        rope, masked = self.rope(input_pos), ~attn_mask[:, 0]
        x = emb_seq
        for i, blk in enumerate(self._layers()):
            x = blk(x, rope, masked, k_caches[i], v_caches[i])
        return self.output(self.norm(x[:, -1]))

    def decode_step(self, x_emb, input_pos, kv_pos, k_caches, v_caches, min_key=None,
                    scratch=None):
        """One token: x_emb (B, 1, D); input_pos (B,); kv_pos a 0-d device
        tensor, the slot every row writes. Keys <= kv_pos are valid, and with
        ``min_key`` (B,) only those >= it. Returns logits (B, vocab): on cuda
        :meth:`decode_chain`'s f32 logits, written into ``scratch`` (an
        ``ops.ar_decode.Scratch`` for B rows, required there), on the CPU
        :meth:`decode_step_reference`'s."""
        if x_emb.device.type == "cuda":
            if scratch is None:
                raise ValueError("ARTransformer.decode_step: on cuda the decode kernels write "
                                 "into a scratch (ops.ar_decode.new_scratch)")
            return self.decode_chain(x_emb, input_pos, kv_pos, k_caches, v_caches, min_key,
                                     scratch)
        return self.decode_step_reference(x_emb, input_pos, kv_pos, k_caches, v_caches, min_key)

    def decode_chain(self, x_emb, input_pos, kv_pos, k_caches, v_caches, min_key, scratch):
        """The decode step as ``ops.ar_decode``'s kernels: five a layer and
        the head, reading the modules' parameters in place and writing into
        ``scratch``. A tensor-parallel module raises: its caches hold every
        head, its weights only this rank's."""
        if any(blk.attention.tp_group is not None for blk in self._layers()):
            raise RuntimeError("ARTransformer.decode_chain: the decode kernels take a whole "
                               "model, not a tensor-parallel part")
        c = self.cfg
        B = x_emb.shape[0]
        table = self.rope_table(x_emb.device)
        x = x_emb.reshape(B, c.dim)
        for i, blk in enumerate(self._layers()):
            att = blk.attention
            ar_decode.attn_in(x, blk.attention_norm.weight, att.wqkv.weight, table, input_pos,
                              kv_pos, scratch.q, k_caches[i], v_caches[i], c.norm_eps)
            ar_decode.attention(scratch.q, k_caches[i], v_caches[i], kv_pos, min_key,
                                scratch.attn, scratch.part, scratch.counters)
            ar_decode.attn_out(scratch.attn, att.wo.weight, x, scratch.x)
            x = scratch.x
            ar_decode.ffn_in(x, blk.ffn_norm.weight, blk.feed_forward_w1.weight,
                             blk.feed_forward_w3.weight, scratch.hidden, c.norm_eps)
            ar_decode.ffn_out(scratch.hidden, blk.feed_forward_w2.weight, x)
        ar_decode.head(x, self.norm.weight, self.output.weight, scratch.logits, c.norm_eps)
        return scratch.logits

    def decode_step_reference(self, x_emb, input_pos, kv_pos, k_caches, v_caches,
                              min_key=None):
        """The plain decode step, the blocks' own forward over a masked
        cache: the CPU's step and the twin of :meth:`decode_chain`. Logits
        (B, vocab) in the model's type."""
        rope = self.rope(input_pos[:, None])
        keys = torch.arange(self.cfg.max_seq_len, device=x_emb.device)[None, :]
        masked = keys > kv_pos
        if min_key is not None:
            masked = masked | (keys < min_key[:, None])
        x = x_emb
        for i, blk in enumerate(self._layers()):
            x = blk(x, rope, masked[:, None, :], k_caches[i], v_caches[i], kv_pos)
        return self.output(self.norm(x[:, 0]))


def sample_token(logits: torch.Tensor, penal_mask: torch.Tensor, q: torch.Tensor,
                 **knobs) -> torch.Tensor:
    """The JAX ``sample_token`` over the last axis: the argmax of
    :func:`token_scores`."""
    return torch.argmax(token_scores(logits, penal_mask, q, **knobs), dim=-1)


def token_scores(logits: torch.Tensor, penal_mask: torch.Tensor, q: torch.Tensor, *,
                 temperature=0.7, top_p=0.7, repetition_penalty=1.5, suppress_eos=False,
                 eos: int = 2048) -> torch.Tensor:
    """``probs / q``, whose argmax is the sampled token. logits (..., vocab)
    (taken to f32), penal_mask (..., vocab) bool (who gets the repetition
    penalty), q (..., vocab) the exponential draws. The penalty comes before
    the EOS suppression; top-p is taken on the pre-temperature logits
    (stable sort, ``cum > top_p`` removed, the first entry always kept);
    temperature is floored at 1e-5. The knobs may be floats or device
    tensors, ``suppress_eos`` a bool or a bool tensor."""
    dev = logits.device
    rp = torch.as_tensor(repetition_penalty, dtype=torch.float32, device=dev)
    logits = logits.float()
    penal = torch.where(logits < 0, logits * rp, logits / rp)
    logits = torch.where(penal_mask, penal, logits)
    is_eos = torch.arange(logits.shape[-1], device=dev) == eos
    logits = logits.masked_fill(is_eos & torch.as_tensor(suppress_eos, device=dev), -torch.inf)

    neg_sorted, order = torch.sort(-logits, dim=-1, stable=True)
    cum = torch.cumsum(torch.softmax(-neg_sorted, dim=-1), dim=-1)
    remove_sorted = cum > torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    remove_sorted[..., 0] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, order, remove_sorted)
    logits = logits.masked_fill(remove, -torch.inf)

    temp = torch.clamp(torch.as_tensor(temperature, dtype=torch.float32, device=dev), min=1e-5)
    return torch.softmax(logits / temp, dim=-1) / q


class ARGenerator:
    """The JAX ``make_generate_fn`` counterpart: ``generate(cond_emb,
    cond_lens, prompt_tokens, prompt_lens, ...) -> (tokens (B, max_new)
    int64, n_tokens (B,))`` on the model's device.

    ``device`` defaults to ``cuda`` and raises when there is none; the model
    is moved there. ``penalty_scope``: ``"first"`` penalises only the first
    generated token (the reference's runtime behaviour), ``"all"`` every
    token emitted so far.
    ``graph``: capture the decode step as a CUDA graph (default: on cuda);
    ``graph=False`` runs the same step eagerly. After a call, ``graph_launches``
    holds the K1/K2/K3 wrappers' launches in one replay (the AR runs none),
    ``fused_launches`` the decode kernels' (``ops.ar_decode.LAUNCHES``) in one
    replay, ``replays`` the replays, ``captures`` the graphs captured (one a call on
    cuda), ``decode_steps`` the decode steps run (the first-token prefill
    not included) and ``decode_s`` the decode's wall seconds, ending in the
    device's result; with ``keep_logits``, ``logits`` holds each step's f32
    logits (row 0 the prefill's, row s decode step s's); the call's static
    buffers and ``graph`` stay alive until the next call."""

    def __init__(self, model: ARTransformer, max_new_tokens: int = 1024, *,
                 temperature: float = 0.7, top_p: float = 0.7,
                 repetition_penalty: float = 1.5, penalty_scope: str = "first",
                 graph: Optional[bool] = None, device=None):
        if penalty_scope not in ("first", "all"):
            raise ValueError(f"penalty_scope {penalty_scope!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ARGenerator: no CUDA device; pass device='cpu' to run on "
                               "the CPU")
        self.model = model.to(self.device)
        self.max_new_tokens = max_new_tokens
        self.defaults = dict(temperature=temperature, top_p=top_p,
                             repetition_penalty=repetition_penalty)
        self.penalty_scope = penalty_scope
        self.use_graph = graph
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_launches: Optional[dict] = None
        self.fused_launches: Optional[int] = None
        self.replays = 0
        self.captures = 0
        self.decode_steps = 0
        self.decode_s = 0.0
        self.logits: Optional[torch.Tensor] = None
        self._state: dict = {}

    def default_draws(self, shape, device, seed: int) -> torch.Tensor:
        """Exponential draws (max_new, B, vocab) f32 from a generator seeded
        with ``seed`` on ``device``, floored at the smallest normal f32."""
        g = torch.Generator(device=device).manual_seed(seed)
        q = torch.empty(shape, device=device).exponential_(generator=g)
        return q.clamp_min_(torch.finfo(torch.float32).tiny)

    @torch.no_grad()
    def generate(self, cond_emb: torch.Tensor, cond_lens, prompt_tokens: torch.Tensor,
                 prompt_lens, *, temperature=None, top_p=None, repetition_penalty=None,
                 draws: Optional[torch.Tensor] = None, draws_fn: Optional[Callable] = None,
                 seed: int = 0, max_tokens=None, keep_logits: bool = False,
                 timer=None) -> tuple[torch.Tensor, torch.Tensor]:
        """cond_emb: (B, C_max, D) regulated narrow-token embeddings, padded;
        cond_lens: int or (B,) true lengths; prompt_tokens: (B, P_max) wide
        tokens, padded; prompt_lens: int or (B,). ``draws`` (max_new, B,
        vocab) f32, or ``draws_fn(shape)``, or :meth:`default_draws` from
        ``seed``: row 0 draws the first token, row s decode step s.

        ``max_tokens``: int or (B,) caps; a row whose emitted tokens reach its
        cap is done, inside the captured step, as an EOS makes it (None: no
        cap). ``keep_logits``: keep each step's f32 logits in
        :attr:`logits` (one copy a step). ``timer``: a
        :class:`~seedvc_tpu_torch.core.profiling.StageTimer` whose stages
        ``ar.prefill`` and ``ar.decode`` this call opens; ``ar.decode``
        counts ``steps``, ``rows``, ``tokens`` (emitted, summed over the
        rows), ``replays`` and ``captures``, and ends after the device
        synchronise the call makes anyway."""
        model, cfg, max_new = self.model, self.model.cfg, self.max_new_tokens
        dev = self.device
        dtype = model.output.weight.dtype
        knobs = {k: torch.tensor(float(v if v is not None else self.defaults[k]),
                                 dtype=torch.float32, device=dev)
                 for k, v in (("temperature", temperature), ("top_p", top_p),
                              ("repetition_penalty", repetition_penalty))}
        B, C_max, _ = cond_emb.shape
        P_max = prompt_tokens.shape[1]
        V, eos = cfg.vocab_size, cfg.eos
        cond_emb = cond_emb.to(dev, dtype)
        cond_lens = torch.as_tensor(cond_lens, device=dev).long().broadcast_to((B,))
        prompt_lens = torch.as_tensor(prompt_lens, device=dev).long().broadcast_to((B,))
        stage = timer if timer is not None else (lambda name: contextlib.nullcontext())
        shape = (max_new, B, V)
        if draws is None:
            draws = draws_fn(shape) if draws_fn is not None else self.default_draws(
                shape, dev, seed)
        draws = draws.to(dev, torch.float32)

        with stage("ar.prefill"):
            # packed prefill, left-padded per row: [pad... ‖ sep ‖ cond ‖ sep ‖ prompt]
            L_pre = 2 + C_max + P_max
            off = (L_pre - (2 + cond_lens + prompt_lens))[:, None]
            idx = torch.arange(L_pre, device=dev)[None, :]
            rel = idx - off
            second_sep = (cond_lens + 1)[:, None]
            is_sep = (rel == 0) | (rel == second_sep)
            in_cond = (rel > 0) & (rel < second_sep)
            cond_g = torch.clamp(rel - 1, 0, C_max - 1)
            tok_g = torch.clamp(rel - second_sep - 1, 0, P_max - 1)
            tok_emb = model.embed_tokens(prompt_tokens.to(dev).long())
            d = cfg.dim
            emb = torch.where(
                is_sep[..., None], model.sep_token_emb.to(dtype)[None, None, :],
                torch.where(in_cond[..., None],
                            torch.gather(cond_emb, 1, cond_g[..., None].expand(-1, -1, d)),
                            torch.gather(tok_emb, 1, tok_g[..., None].expand(-1, -1, d))))
            # RoPE positions restart at the second sep; pad positions are 0
            pos = torch.where(rel < second_sep, torch.clamp(rel, min=0), rel - second_sep)
            # causal from each row's start; a pad query attends to itself only
            q_idx = idx[:, :, None]
            keys = idx[:, None, :]
            mask = (keys <= q_idx) & ((keys >= off[..., None]) | (keys == q_idx))
            kc, vc = model.new_caches(B, dev, dtype)
            logits = model.prefill(emb, pos, mask[:, None], kc, vc)

            vocab = torch.arange(V, device=dev)
            first = sample_token(logits, torch.zeros((B, V), dtype=torch.bool, device=dev),
                                 draws[0], suppress_eos=True, eos=eos, **knobs)
            tokens = torch.zeros((B, max_new), dtype=torch.long, device=dev)
            tokens[:, 0] = first
            steps = torch.ones(B, dtype=torch.long, device=dev)
            cap = (torch.full((B,), max_new, dtype=torch.long, device=dev) if max_tokens is None
                   else torch.as_tensor(max_tokens, device=dev).long().broadcast_to((B,)).clone())
            self.logits = None
            if keep_logits:
                self.logits = torch.zeros(shape, dtype=torch.float32, device=dev)
                self.logits[0] = logits.float()
            s = {"step": torch.ones((), dtype=torch.long, device=dev),
                 "steps": steps, "cap": cap,
                 "kv_pos": torch.full((), L_pre, dtype=torch.long, device=dev),
                 "input_pos": prompt_lens + 1, "last": first, "tokens": tokens,
                 "presence": vocab[None, :] == first[:, None],
                 "done": steps >= cap,
                 "kc": kc, "vc": vc, "min_key": off[:, 0], "draws": draws, "vocab": vocab,
                 "logits": self.logits, **knobs,
                 "scratch": (ar_decode.new_scratch(B, cfg, dev, dtype) if dev.type == "cuda"
                             else None)}
            self._state = s

        def step():
            """One decode step over the static buffers of ``s``, in place;
            reads nothing back to the host, so a CUDA graph can hold it."""
            lg = model.decode_step(model.embed_tokens(s["last"][:, None]), s["input_pos"],
                                   s["kv_pos"], s["kc"], s["vc"], s["min_key"],
                                   scratch=s["scratch"])
            penal = (s["vocab"][None, :] == s["tokens"][:, :1] if self.penalty_scope == "first"
                     else s["presence"])
            row = torch.clamp(s["step"], max=max_new - 1).reshape(1)
            if s["logits"] is not None:
                s["logits"].index_copy_(0, row, lg.float()[None])
            q = s["draws"].index_select(0, row)[0]
            tok = sample_token(lg, penal, q, temperature=s["temperature"], top_p=s["top_p"],
                               repetition_penalty=s["repetition_penalty"],
                               suppress_eos=s["step"] < 10, eos=eos)
            is_eos = tok == eos
            active = ~s["done"]
            write = active & ~is_eos
            col = torch.clamp(s["steps"], max=max_new - 1)[:, None]
            s["tokens"].scatter_(1, col, torch.where(write[:, None], tok[:, None],
                                                     s["tokens"].gather(1, col)))
            s["presence"].scatter_(1, tok[:, None],
                                   s["presence"].gather(1, tok[:, None]) | write[:, None])
            s["steps"].add_(write.long())
            s["kv_pos"].add_(1)
            s["input_pos"].add_(1)
            s["step"].add_(1)
            s["last"].copy_(torch.where(active, tok, s["last"]))
            s["done"].logical_or_(is_eos | (s["steps"] >= s["cap"]))

        use_graph = dev.type == "cuda" if self.use_graph is None else self.use_graph
        self.graph, self.graph_launches, self.replays, self.captures = None, None, 0, 0
        self.fused_launches = None
        n_steps = 0
        t0 = time.perf_counter()
        with stage("ar.decode"):
            if max_new > 1 and use_graph:
                # the first decode step runs eagerly on a side stream (it warms
                # the kernels and the allocator); capturing runs nothing
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    step()
                torch.cuda.current_stream(dev).wait_stream(side)
                n_steps = 1
                before, fused_before = launches.counts(), ar_decode.LAUNCHES
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    step()
                self.captures = 1
                self.graph_launches = {k: v - before[k] for k, v in launches.counts().items()}
                self.fused_launches = ar_decode.LAUNCHES - fused_before
            while n_steps < max_new - 1:
                if n_steps % CHECK_EVERY == 0 and n_steps and bool(s["done"].all()):
                    break
                if self.graph is not None:
                    self.graph.replay()
                    self.replays += 1
                else:
                    step()
                n_steps += 1
            out_tokens, out_steps = s["tokens"].clone(), s["steps"].clone()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if timer is not None:
                for key, n in (("steps", n_steps), ("rows", B),
                               ("tokens", int(out_steps.sum())), ("replays", self.replays),
                               ("captures", self.captures)):
                    timer.count(key, n)
        self.decode_s = time.perf_counter() - t0
        self.decode_steps = n_steps
        return out_tokens, out_steps
