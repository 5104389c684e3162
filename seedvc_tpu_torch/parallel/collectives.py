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
  rank order (uneven shares allowed), as a replicated tensor.

Every function is the identity when the group is None (an axis of size 1).
"""

from __future__ import annotations

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


def gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` rows that the ranks of ``group`` hold in :func:`row_split`
    parts (``x`` is this rank's part, possibly empty), joined in rank order."""
    if group is None:
        return x
    parts = dist.get_world_size(group)
    per = -(-n // parts)
    buf = x.new_zeros((per, *x.shape[1:]), dtype=torch.float32)  # bf16 carried exactly
    buf[: x.shape[0]] = x
    pieces = all_gather_list(buf, group)
    return torch.cat(pieces, 0)[:n].to(x.dtype)
