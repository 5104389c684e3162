"""The (data, model) mesh of ranks and its batch helpers (port of
``seedvc_tpu/parallel/mesh.py``).

The JAX package lays its devices on a named ``jax.sharding.Mesh`` and lets
XLA's SPMD partitioner insert the collectives:

- ``data``: the utterance batch (data parallelism) and the stacked CFG
  branches of the sampler; gradients are averaged over it;
- ``model``: tensor parallelism of the DiT / AR attention and FFN weights.

Here the devices are processes, one a GPU, in the default process group
(:mod:`seedvc_tpu_torch.parallel.distributed`). :func:`make_mesh` lays the
ranks out row-major as ``(n_data, n_model)`` (rank ``r`` sits at data index
``r // n_model``, model index ``r % n_model``, as JAX reshapes its device
list) in a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")``, whose per-dim process groups carry the explicit
collectives. One process without a process group gets a 1 x 1 mesh without
a ``DeviceMesh``, on which every collective is a no-op.

:func:`set_mesh` stands in for ``jax.set_mesh``: code that takes a mesh axis
by name (``euler_solve(shard_axis=...)``, ``BSQ(pmean_axis=...)``) finds the
mesh in the innermost ``set_mesh`` block.

:class:`SeqShard` splits a time axis over a mesh axis (the samplers'
``seq_shard_axis``): this rank's rows, the all-gather back to every row and
the halo of a convolution. The sampler makes it the current one
(:func:`seq_shard_block`) while it calls the estimator, which reads it with
:func:`current_seq_shard`.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from seedvc_tpu_torch.parallel.collectives import (gather_counts, halo_index, halo_rows,
                                                   split_counts)


@dataclass(frozen=True)
class AxisNames:
    data: str = "data"
    model: str = "model"


AXES = AxisNames()


class Mesh:
    """A (data, model) grid of ranks. ``shape`` maps each axis name to its
    size; ``coord`` is this rank's (data, model) index; ``device_mesh`` is
    the ``DeviceMesh`` over the process group (None for one process without
    a group, or for a mesh that only names sizes, as the sharding rules
    take)."""

    def __init__(self, n_data: int, n_model: int, coord: tuple = (0, 0), device_mesh=None,
                 ranks: Optional[np.ndarray] = None):
        self.shape = {AXES.data: int(n_data), AXES.model: int(n_model)}
        self.coord = {AXES.data: int(coord[0]), AXES.model: int(coord[1])}
        self.device_mesh = device_mesh
        self.ranks = (np.arange(n_data * n_model).reshape(n_data, n_model)
                      if ranks is None else ranks)

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, coord={self.coord})"

    @property
    def size_total(self) -> int:
        return self.shape[AXES.data] * self.shape[AXES.model]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coord[axis]

    def group(self, axis: str):
        """The process group of this rank's ranks along ``axis``; None when
        the axis has size 1 (nothing to communicate)."""
        if self.shape[axis] == 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def all_group(self):
        """The group of every rank of the mesh; None for a 1 x 1 mesh."""
        if self.size_total == 1 or self.device_mesh is None:
            return None
        return dist.group.WORLD

    def fresh_group(self, axis: str):
        """A new process group of this rank's ranks along ``axis`` (None for
        an axis of size 1), for collectives that run on another thread than
        the ones of :meth:`group`: each group keeps its own order. Every rank
        calls it, in the same order."""
        if self.group(axis) is None:
            return None
        lines = self.ranks.T if axis == AXES.data else self.ranks
        mine = None
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if dist.get_rank() in line:
                mine = g
        return mine

    @property
    def first_rank(self) -> int:
        return int(self.ranks.ravel()[0])


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[int]] = None, device_type: Optional[str] = None) -> Mesh:
    """Create a (data, model) mesh over ``devices``: the global ranks in the
    order to lay out (default every rank of the process group, or the one
    process without one; a mesh spans the whole group).
    ``n_data`` defaults to ``len(devices) // n_model``. ``device_type`` is
    the ``DeviceMesh``'s (default ``cuda`` under NCCL, else ``cpu``; FSDP
    needs it to be the parameters' device type)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = np.asarray(list(range(world)) if devices is None else list(devices))
    total = ranks.size
    if n_data is None:
        n_data = total // n_model
    if n_data * n_model != total:
        raise ValueError(f"mesh {n_data}x{n_model} != {total} devices")
    grid = ranks.reshape(n_data, n_model)
    if sorted(ranks.tolist()) != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the process group ({world}), "
                         f"not {ranks.tolist()}")
    if not dist.is_initialized():
        return Mesh(n_data, n_model, (0, 0), None, grid)
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=(AXES.data, AXES.model))
    coord = tuple(int(c) for c in np.argwhere(grid == dist.get_rank())[0])
    return Mesh(n_data, n_model, coord, dm, grid)


def _map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def data_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row batch split evenly over ``data``."""
    n_data = mesh.size(AXES.data)
    if n % n_data:
        raise ValueError(f"batch of {n} rows does not split over the data axis ({n_data})")
    per = n // n_data
    i = mesh.index(AXES.data)
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of the leading (batch) axis of every tensor or array
    of ``tree`` over ``data``; 0-d leaves and None pass as they are."""
    def rows(x):
        if getattr(x, "ndim", 0) >= 1:
            return x[data_rows(mesh, x.shape[0])]
        return x
    return _map(rows, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it (a copy,
    broadcast over the mesh); other leaves pass as they are."""
    group = mesh.all_group()

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().clone()
        if group is not None:
            dist.broadcast(x, src=mesh.first_rank, group=group)
        return x
    return _map(bcast, tree)


class _Stack(threading.local):
    """Each thread's (mesh, batch axis or None) blocks, innermost last: a
    prefetch thread's work never sees the step's mesh."""

    def __init__(self):
        self.blocks: list = []


_CURRENT = _Stack()


@contextlib.contextmanager
def set_mesh(mesh: Mesh, batch_axis: Optional[str] = None):
    """Make ``mesh`` the one that axis names refer to inside the block.
    ``batch_axis``: the block's tensors hold this rank's rows of a batch
    split over that axis (the sharded train steps), so a reduction over the
    batch (:func:`batch_max`) spans the axis, as it spans a JAX global
    array."""
    _CURRENT.blocks.append((mesh, batch_axis))
    try:
        yield mesh
    finally:
        _CURRENT.blocks.pop()


def batch_split():
    """(mesh, axis) of the innermost :func:`set_mesh` block whose batch is
    split over ``axis`` (an axis of size > 1), else None."""
    if not _CURRENT.blocks or _CURRENT.blocks[-1][1] is None:
        return None
    mesh, axis = _CURRENT.blocks[-1]
    return (mesh, axis) if mesh.group(axis) is not None else None


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a max over this rank's rows) maximised over the batch axis of
    the innermost :func:`set_mesh`; ``x`` itself outside one."""
    split = batch_split()
    if split is None:
        return x
    from seedvc_tpu_torch.parallel.collectives import all_reduce_max

    mesh, axis = split
    return all_reduce_max(x, mesh.group(axis))


def current_mesh(axis: Optional[str] = None) -> Mesh:
    """The innermost :func:`set_mesh` mesh; raises when there is none (or it
    has no axis ``axis``)."""
    if not _CURRENT.blocks:
        raise ValueError(f"mesh axis {axis!r} is named outside a set_mesh(...) block")
    mesh = _CURRENT.blocks[-1][0]
    if axis is not None and axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {tuple(mesh.shape)})")
    return mesh


class SeqShard:
    """A time axis split over mesh axis ``axis``: ``counts[r]`` rows on rank
    r of the axis, in rank order; this rank (``index``) holds rows ``rows``
    of the ``total``. :meth:`over` splits as XLA splits a sharded dimension
    (ceil(n / ranks) rows a rank, the last ranks short or empty);
    :meth:`with_lead` puts rows before the first rank's part (the DiT's
    prefix tokens). A rank with no rows still takes part in every
    collective."""

    def __init__(self, axis: str, group, index: int, counts: Sequence[int]):
        self.axis, self.group, self.index = axis, group, index
        self.counts = tuple(int(c) for c in counts)
        self.total = sum(self.counts)
        start = sum(self.counts[:index])
        self.rows = slice(start, start + self.counts[index])
        self._halo: dict = {}

    @classmethod
    def over(cls, axis: str, n: int) -> "SeqShard":
        """``n`` rows split over ``axis`` of the innermost ``set_mesh`` mesh."""
        mesh = current_mesh(axis)
        return cls(axis, mesh.group(axis), mesh.index(axis), split_counts(n, mesh.size(axis)))

    def with_lead(self, lead: int) -> "SeqShard":
        """The same split with ``lead`` more rows at the start, held by the
        first rank."""
        return SeqShard(self.axis, self.group, self.index,
                        (self.counts[0] + lead, *self.counts[1:]))

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole ``x`` (time on dim 1)."""
        return x.narrow(1, self.rows.start, self.counts[self.index])

    def positions(self, device) -> torch.Tensor:
        """The global positions of this rank's rows."""
        return torch.arange(self.rows.start, self.rows.stop, device=device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's part (time on dim 1; this rank's is ``x``), joined."""
        return gather_counts(x, self.group, self.counts, 1)

    def halo(self, x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
        """This rank's part of ``F.pad(whole, (pad, pad), mode)`` along the
        last dim (a Conv1d's input, time last): ``x`` with the ``pad`` rows
        before and after it from the ranks that hold them, and ``reflect``
        or ``constant`` padding at the sequence's two ends only."""
        if pad == 0:
            return x
        if self.group is None:
            return F.pad(x, (pad, pad), mode=mode)
        key = (pad, mode, x.device)
        if key not in self._halo:
            e, idx = halo_index(self.counts, self.index, pad, mode)
            self._halo[key] = e, torch.from_numpy(idx).to(x.device)
        e, idx = self._halo[key]
        rows = halo_rows(x, self.group, e, idx)
        return torch.cat([rows[..., :pad], x, rows[..., pad:]], -1)


class _SeqStack(threading.local):
    def __init__(self):
        self.blocks: list = []


_SEQ = _SeqStack()


@contextlib.contextmanager
def seq_shard_block(seq: Optional[SeqShard]):
    """Make ``seq`` (None: no split) the current time split inside the block."""
    _SEQ.blocks.append(seq)
    try:
        yield seq
    finally:
        _SEQ.blocks.pop()


def current_seq_shard() -> Optional[SeqShard]:
    """The innermost :func:`seq_shard_block`'s split, else None."""
    return _SEQ.blocks[-1] if _SEQ.blocks else None
