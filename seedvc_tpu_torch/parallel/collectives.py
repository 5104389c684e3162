"""The explicit collectives that stand in for XLA's inserted ones.

- :func:`copy_to_group` / :func:`reduce_from_group`: the Megatron pair
  around a tensor-parallel block. The first is the identity forward and sums
  the gradient over the ``model`` group backward (the replicated input of a
  column-parallel layer feeds every rank's shard); the second sums the
  row-parallel layer's partial outputs forward and passes the gradient
  through backward (every rank holds the same copy of what follows).
- :func:`pmean`: the mean over a group forward and, backward, the mean of
  the ranks' gradients, which is ``jax.lax.pmean``'s transpose. Each rank
  backpropagates its own copy of the objective and the data axis averages
  the gradients, so a rank's share of a mean over ranks is the mean of the
  ranks' gradients.
- :func:`gather_rows`: the rows that each rank of a group holds, joined in
  rank order (uneven shares allowed), as a replicated tensor;
  :func:`gather_counts` the same along any dim with given shares.
- :func:`halo_rows`: the rows on either side of this rank's part of a
  sequence split over a group, from the ranks that hold them (the halo
  exchange of a convolution whose input is split along time).

Every function is the identity when the group is None (an axis of size 1).
"""

from __future__ import annotations

import bisect

import numpy as np
import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x / n

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / n, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _PMean.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (no gradient), in a new tensor."""
    x = x.detach().contiguous().clone()
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Max of ``x`` (lengths, counts: integers below 2^24) over ``group``,
    carried as f32, which every backend reduces on every device."""
    if group is None:
        return x.detach().clone()
    y = x.detach().float().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y.to(x.dtype)


def all_gather_list(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (same shape on every rank), in rank order."""
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def row_split(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``n`` rows in ``parts`` parts of ceil(n / parts) rows
    (the last ones short or empty), as XLA pads an uneven shard."""
    per = -(-n // parts)
    return slice(min(index * per, n), min((index + 1) * per, n))


def split_counts(n: int, parts: int) -> list:
    """The rows of each :func:`row_split` part."""
    return [len(range(n)[row_split(n, parts, r)]) for r in range(parts)]


def gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` rows that the ranks of ``group`` hold in :func:`row_split`
    parts (``x`` is this rank's part, possibly empty), joined in rank order."""
    if group is None:
        return x
    return gather_counts(x, group, split_counts(n, dist.get_world_size(group)), 0)


def _buffer(x: torch.Tensor, shape) -> torch.Tensor:
    """A zero buffer that carries ``x``'s values exactly: in x's type for
    f32, f16 and bf16, else f32."""
    keep = x.dtype in (torch.float32, torch.float16, torch.bfloat16)
    return x.new_zeros(shape, dtype=x.dtype if keep else torch.float32)


def _gather_bits(buf: torch.Tensor, group) -> list:
    """:func:`all_gather_list` of ``buf``, a bf16 buffer as the 16-bit
    patterns of an f16 one (gloo has no bf16; a gather only copies bits)."""
    if buf.dtype != torch.bfloat16:
        return all_gather_list(buf, group)
    return [p.view(torch.bfloat16) for p in all_gather_list(buf.view(torch.float16), group)]


def gather_counts(x: torch.Tensor, group, counts, dim: int) -> torch.Tensor:
    """The parts of a sequence that the ranks of ``group`` hold along ``dim``,
    ``counts[r]`` rows on rank r (0 allowed; ``x`` is this rank's part),
    joined in rank order: one all-gather of parts padded to the largest."""
    if group is None:
        return x
    shape = list(x.shape)
    shape[dim] = max(counts)
    buf = _buffer(x, shape)
    buf.narrow(dim, 0, x.shape[dim]).copy_(x)
    pieces = _gather_bits(buf, group)
    return torch.cat([p.narrow(dim, 0, c) for p, c in zip(pieces, counts)], dim).to(x.dtype)


def halo_index(counts, index: int, pad: int, mode: str) -> tuple[int, np.ndarray]:
    """Where :func:`halo_rows` finds each of the ``2 * pad`` rows beside rank
    ``index``'s part of a sequence split in ``counts``: (e, idx). Every rank
    contributes its first and its last e = min(pad + 1, max(counts)) rows
    (2e slots a rank, rank-major), and a zero slot follows them all; idx[j]
    is the slot of halo row j (the ``pad`` rows before the part, then the
    ``pad`` after). Rows past the sequence's ends are ``F.pad``'s: mirrored
    (``reflect``, excluding the edge row) or the zero slot (``constant``).
    With XLA's split (ceil(n / ranks) rows a rank, the last ones short) a
    halo row lies within e rows of its holder's first or last row."""
    n, starts = sum(counts), np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
    e = min(pad + 1, max(counts))
    lo, hi = starts[index], starts[index] + counts[index]
    idx = []
    for g in [*range(lo - pad, lo), *range(hi, hi + pad)]:
        if not 0 <= g < n:
            if mode == "constant":
                idx.append(2 * e * len(counts))
                continue
            g = -g if g < 0 else 2 * (n - 1) - g
        r = bisect.bisect_right(starts, g) - 1
        while counts[r] == 0:  # empty parts start where the next one does
            r -= 1
        o = g - starts[r]
        if o < e:
            idx.append(2 * e * r + o)
        elif o >= counts[r] - e:
            idx.append(2 * e * r + 2 * e - (counts[r] - o))
        else:
            raise ValueError(f"halo row {g} is not within {e} rows of rank {r}'s edges")
    return e, np.asarray(idx, dtype=np.int64)


def halo_rows(x: torch.Tensor, group, e: int, idx: torch.Tensor) -> torch.Tensor:
    """The halo rows of ``x`` (this rank's part, time on the last dim) that
    :func:`halo_index` located: one all-gather of every rank's first and last
    ``e`` rows, then ``idx`` (on x's device) picks them. Returns (..., len(idx))."""
    n = x.shape[-1]
    h = min(e, n)
    buf = _buffer(x, (*x.shape[:-1], 2 * e))
    buf[..., :h] = x[..., :h]
    buf[..., 2 * e - h:] = x[..., n - h:]
    pieces = _gather_bits(buf, group)
    flat = torch.cat([*pieces, buf.new_zeros((*x.shape[:-1], 1))], -1)
    return flat.index_select(-1, idx).to(x.dtype)
