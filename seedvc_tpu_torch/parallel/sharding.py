"""Parameter sharding rules and where each tensor of a train state lives
(port of ``seedvc_tpu/parallel/sharding.py``).

The rules are the JAX package's Megatron split, as regexes over the flax
parameter paths joined by ``.`` (the port's parameter names mirror those
paths; a Linear's ``weight`` is the flax Dense ``kernel`` transposed): the
fused QKV projection and the SwiGLU's ``w1`` / ``w3`` are column parallel
(their output features split over ``model``), ``wo`` and ``w2`` row parallel
(their input features split). A spec is a tuple with one mesh axis name (or
None) per flax dimension; ``()`` is replicated. An axis that does not divide
its dimension drops the whole spec to replicated. With ``fsdp_axis`` every
parameter of at least ``fsdp_min_elems`` elements is also split over that
axis along its largest still-unsplit dimension that the axis divides.

The specs decide which parameters are split. How a split module computes
is the module's own (``tp_splits`` / ``shard_model_`` on
``nn.layers.Attention``, ``nn.layers.FeedForward`` and
``models.ar.ARAttention``): XLA may cut the fused ``[q | k | v]`` columns
anywhere, but a rank that computes attention needs whole heads, so the port
keeps heads ``[r H / n, (r + 1) H / n)`` of q and the matching KV heads of k
and v, and leaves a layer whose heads (or grouped KV heads) do not divide
over ``model`` replicated. :class:`Layout` records the split of every tensor
so that checkpoints gather full tensors and restore at any mesh.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from seedvc_tpu_torch.parallel import collectives as C
from seedvc_tpu_torch.parallel.mesh import AXES, Mesh


def P(*dims) -> tuple:
    """A partition spec: one mesh axis name (or None) per dimension."""
    return tuple(dims)


# (regex over the '.'-joined flax path, spec) -- first match wins. Flax
# Dense kernels are (in, out); Conv kernels are (k, in, out).
DIT_RULES: Sequence[tuple[str, tuple]] = (
    # attention: fused qkv projection -> column parallel (out dim sharded)
    (r".*attention\.wqkv\.kernel", P(None, AXES.model)),
    (r".*attention\.wo\.kernel", P(AXES.model, None)),
    # SwiGLU: w1/w3 column parallel, w2 row parallel
    (r".*feed_forward\.w1\.kernel", P(None, AXES.model)),
    (r".*feed_forward\.w3\.kernel", P(None, AXES.model)),
    (r".*feed_forward\.w2\.kernel", P(AXES.model, None)),
    # biases of column-parallel layers follow the out dim
    (r".*attention\.wqkv\.bias", P(AXES.model)),
    (r".*feed_forward\.w[13]\.bias", P(AXES.model)),
)


def _spec_for(path: str, rules: Sequence[tuple[str, tuple]]) -> tuple:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return P()  # replicated


def _add_fsdp_axis(spec: tuple, shape: tuple, mesh: Mesh, axis: str, min_elems: int) -> tuple:
    """Split the largest still-unsplit dimension that ``axis`` divides of a
    parameter of at least ``min_elems`` elements over ``axis`` (the ZeRO-3 /
    FSDP placement; it composes with the tensor-parallel split)."""
    if int(np.prod(shape, dtype=np.int64)) < min_elems or axis not in mesh.shape:
        return spec
    n = mesh.shape[axis]
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best = -1
    for i, (d, s) in enumerate(zip(shape, dims)):
        if s is None and d % n == 0 and (best < 0 or d > shape[best]):
            best = i
    if best < 0:
        return spec
    dims[best] = axis
    return P(*dims)


def spec_of(path: str, shape: tuple, mesh: Mesh, rules=DIT_RULES,
            fsdp_axis: Optional[str] = None, fsdp_min_elems: int = 65536) -> tuple:
    """The spec of one parameter at flax ``path`` with flax ``shape``."""
    spec = _spec_for(path, rules)
    if spec != P() and any(a is not None and d % mesh.shape[a] for d, a in zip(shape, spec)):
        spec = P()  # an axis that does not divide its dimension
    if fsdp_axis is not None:
        spec = _add_fsdp_axis(spec, tuple(shape), mesh, fsdp_axis, fsdp_min_elems)
    return spec


def logical_to_sharding(params, mesh: Mesh, rules=DIT_RULES, fsdp_axis: Optional[str] = None,
                        fsdp_min_elems: int = 65536):
    """A tree of specs matching the nested-dict tree ``params`` (leaves with
    a ``shape``), its paths joined by ``.``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else str(k)) for k, v in node.items()}
        return spec_of(path, tuple(node.shape), mesh, rules, fsdp_axis, fsdp_min_elems)
    return walk(params, "")


def dit_param_sharding(params, mesh: Mesh):
    """Specs for the DiT parameter tree (tensor parallel over ``model``)."""
    return logical_to_sharding(params, mesh, DIT_RULES)


# ---------------------------------------------------------------------------
# port parameters: their flax paths, and where each lives


def flax_view(module: nn.Module, name: str, shape: tuple) -> tuple[str, tuple, tuple]:
    """(flax path, flax shape, perm) of the port parameter ``name`` of shape
    ``shape``: flax dimension i is torch dimension perm[i]."""
    from seedvc_tpu_torch.weights import _TRANSPOSED, _named, _to_flax

    *path, leaf = name.split(".")
    mod = module.get_submodule(".".join(path))
    # the flax layout of an array whose axes are labelled by their sizes
    probe = np.empty(tuple(range(2, 2 + len(shape))), np.int8)
    fname, out = _to_flax(mod, leaf, probe)
    perm = tuple(int(s) - 2 for s in out.shape)
    if isinstance(mod, _TRANSPOSED) and not _named(mod, "FlaxConvTranspose1d"):
        fname = f"{path.pop()}_{fname}"
    flax_shape = tuple(shape[p] for p in perm)
    return ".".join([*path, fname]), flax_shape, perm


def module_specs(module: nn.Module, mesh: Mesh, rules=DIT_RULES, fsdp_axis: Optional[str] = None,
                 fsdp_min_elems: int = 65536) -> dict:
    """name -> (spec over flax dimensions, perm) for every parameter of
    ``module`` (full, unsplit shapes)."""
    out = {}
    for name, p in module.named_parameters():
        path, fshape, perm = flax_view(module, name, tuple(p.shape))
        out[name] = (spec_of(path, fshape, mesh, rules, fsdp_axis, fsdp_min_elems), perm)
    return out


@dataclass(frozen=True)
class TPSplit:
    """A tensor-parallel split along torch dimension ``dim``, made of
    consecutive segments of ``sizes`` (the fused [q | k | v] output, or one
    segment), each cut into ``n_model`` equal parts; rank r keeps part r of
    every segment."""

    dim: int
    sizes: tuple


@dataclass(frozen=True)
class ParamLayout:
    tp: Optional[TPSplit] = None
    fsdp_dim: Optional[int] = None  # torch dimension split over data (after tp)

    @property
    def axes(self) -> tuple:
        return tuple(a for a, on in ((AXES.data, self.fsdp_dim is not None),
                                     (AXES.model, self.tp is not None)) if on)


def tp_slice(t: torch.Tensor, split: TPSplit, n: int, index: int) -> torch.Tensor:
    parts, start = [], 0
    for size in split.sizes:
        part = size // n
        parts.append(t.narrow(split.dim, start + index * part, part))
        start += size
    return torch.cat(parts, split.dim) if len(parts) > 1 else parts[0].clone()


def tp_join(pieces: list, split: TPSplit) -> torch.Tensor:
    n = len(pieces)
    out, start = [], 0
    for size in split.sizes:
        part = size // n
        out += [p.narrow(split.dim, start, part) for p in pieces]
        start += part
    return torch.cat(out, split.dim)


class Layout:
    """Where each named tensor of a train state lives on ``mesh``:
    ``entries`` maps a parameter name to its :class:`ParamLayout`; a name
    without an entry is replicated. ``gather`` and ``scatter`` move between
    this rank's piece and the full tensor (collectives: every rank calls
    them, in the same order)."""

    def __init__(self, mesh: Mesh, entries: Optional[dict] = None):
        self.mesh = mesh
        self.entries = dict(entries or {})

    def of(self, name: str) -> ParamLayout:
        return self.entries.get(name, ParamLayout())

    def axes(self, name: str) -> tuple:
        return self.of(name).axes

    def group(self, axes: tuple):
        """The group over which pieces split along ``axes`` add up."""
        if not axes:
            return None
        if len(axes) == 2:
            return self.mesh.all_group()
        return self.mesh.group(axes[0])

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        lay, mesh = self.of(name), self.mesh
        t = local.detach()
        if lay.fsdp_dim is not None:
            t = torch.cat(C.all_gather_list(t.contiguous(), mesh.group(AXES.data)), lay.fsdp_dim)
        if lay.tp is not None:
            t = tp_join(C.all_gather_list(t.contiguous(), mesh.group(AXES.model)), lay.tp)
        return t

    def scatter(self, name: str, full: torch.Tensor) -> torch.Tensor:
        lay, mesh = self.of(name), self.mesh
        t = full.detach()
        if lay.tp is not None:
            t = tp_slice(t, lay.tp, mesh.size(AXES.model), mesh.index(AXES.model))
        if lay.fsdp_dim is not None:
            t = t.chunk(mesh.size(AXES.data), lay.fsdp_dim)[mesh.index(AXES.data)]
        return t.contiguous().clone()


# one process: every tensor whole (the layout of a state no mesh has cut)
WHOLE = Layout(Mesh(1, 1))


class TensorParallel:
    """Mixin of a module that can hold its part of a tensor-parallel split:
    ``tp_splits()`` names its split weights (full shapes), ``tp_divides(n)``
    says whether it splits over ``n`` ranks, and ``shard_model_`` keeps this
    rank's part and the group that joins the parts. Until then
    ``tp_group`` is None and the module computes as it did."""

    tp_group = None

    def tp_splits(self) -> dict:
        raise NotImplementedError

    def tp_divides(self, n: int) -> bool:
        raise NotImplementedError

    def _tp_local(self, n: int) -> None:
        """Divide the module's own head / feature counts by ``n``."""

    def shard_model_(self, index: int, n: int, group) -> None:
        for name, split in self.tp_splits().items():
            *path, leaf = name.split(".")
            mod = self.get_submodule(".".join(path))
            old = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(tp_slice(old.detach(), split, n, index),
                                            requires_grad=old.requires_grad))
        self._tp_local(n)
        self.tp_group = group
