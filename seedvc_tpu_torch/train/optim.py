"""Optimizers and LR schedules, written to optax's semantics (port of
``seedvc_tpu/train/optim.py``).

``make_optimizer`` is ``optax.chain(clip_by_global_norm(grad_clip),
adamw(lr, b1, b2, eps, weight_decay))`` followed by the trailing runtime
``lr_scale`` of ``with_lr_scale``; ``make_multi_optimizer`` gives each
top-level module (``cfm``, ``length_regulator``) its own such chain, so the
clip norm is taken per module. What the update does, as optax does it:

- the global norm of the gradients (of a group) is taken first; above
  ``grad_clip`` every gradient is scaled by ``grad_clip / norm``;
- Adam moments ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g²``, a
  step count incremented before the bias corrections ``1 - b^count``;
- ``update = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * param``, with the
  parameter taken before the update (decoupled decay);
- times ``-lr(count)``, where the schedule reads the count as it was before
  this update (0 on the first step), then times the runtime ``lr_scale``.

``make_v2_optimizer`` is the v2 trainer's ``optax.chain(
clip_by_global_norm(grad_clip), multi_transform({cfm: adamw, ar: adamw or
set_to_zero}))``: one clip norm over every module (``global_clip``), and a
frozen group (``frozen``) that takes no update, no weight decay and holds no
moments, as ``optax.set_to_zero`` does.

A parameter without a gradient (an unused branch) is updated as if its
gradient were zero, as optax updates every leaf of the tree.

On a mesh (``layout``, a :class:`~seedvc_tpu_torch.parallel.sharding.Layout`)
each rank holds its piece of a split parameter, gradient and moments (a
``DTensor`` under FSDP, whose local shard is updated in place). The norms are
still those of the full tensors, as optax's ``global_norm`` sees global
arrays: each rank's sum of squares of the pieces split over an axis is
summed over that axis's group, and a piece replicated over an axis counts
once. The state holds
fp32 moments on the parameters' device and the count and scale as Python
numbers, so an update reads nothing back from the device. The schedules are
computed in float32, as jnp computes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Union

import numpy as np
import torch

from seedvc_tpu_torch.parallel.collectives import all_reduce_sum
from seedvc_tpu_torch.parallel.sharding import WHOLE, Layout

Schedule = Callable[[int], float]
LR = Union[float, Schedule]

_F = np.float32


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_scale: float = 0.1) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, warmup + 1), base_lr * final_scale)``."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup + 1) - warmup
    peak = _F(base_lr)
    alpha = _F(0.0) if base_lr == 0 else _F(base_lr * final_scale) / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = _F(1) - _F(min(max(count, 0), warmup)) / _F(warmup)
            return float((_F(0) - peak) * frac + peak)
        k = _F(min(count - warmup, decay))
        cosine = _F(0.5) * (_F(1) + _F(np.cos(_F(np.pi) * k / _F(decay))))
        return float(peak * ((_F(1) - alpha) * cosine + alpha))

    return schedule


def exponential(base_lr: float, gamma: float = 0.999996) -> Schedule:
    return lambda step: float(_F(base_lr) * _F(gamma) ** _F(step))


@dataclass
class GroupState:
    """One AdamW chain's state: the update count and the fp32 moments."""

    count: int
    mu: list
    nu: list


@dataclass
class OptState:
    """Per-group AdamW states and the runtime LR multiplier."""

    groups: dict
    lr_scale: float = 1.0
    names: dict = field(default_factory=dict)  # group -> parameter names, in order


class Optimizer:
    """A clip + AdamW chain per group of parameters, then ``lr_scale``.
    ``init(params)`` and ``update(grads, state, params)`` take dicts of
    name -> tensor (``dict(module.named_parameters())``); ``update`` returns
    (updates, new state), the updates to be added to the parameters."""

    def __init__(self, lr: dict, group_of: Callable[[str], str], *, grad_clip: float,
                 weight_decay: float, b1: float, b2: float, eps: float,
                 global_clip: bool = False, frozen: tuple = ()):
        self.lr = {k: (v if callable(v) else (lambda _c, _v=v: _v)) for k, v in lr.items()}
        self.group_of = group_of
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.global_clip = global_clip  # one clip norm over every group
        self.frozen = frozenset(frozen)  # groups updated by optax.set_to_zero
        unknown = self.frozen - set(self.lr)
        if unknown:
            raise KeyError(f"frozen groups {sorted(unknown)} are not groups ({list(self.lr)})")

    def _groups(self, names) -> dict:
        groups: dict = {k: [] for k in self.lr}
        for n in names:
            g = self.group_of(n)
            if g not in groups:
                raise KeyError(f"parameter {n} belongs to no optimizer group ({list(groups)})")
            groups[g].append(n)
        return groups

    def init(self, params: dict) -> OptState:
        names = self._groups(params)
        groups = {g: GroupState(0, [] if g in self.frozen else
                                [torch.zeros_like(local(params[n]), dtype=torch.float32)
                                 for n in ns],
                                [] if g in self.frozen else
                                [torch.zeros_like(local(params[n]), dtype=torch.float32)
                                 for n in ns])
                  for g, ns in names.items()}
        return OptState(groups, 1.0, names)

    def _clip_factor(self, gs: list, names: list, layout: Layout) -> torch.Tensor:
        norm = global_norm(gs, layout, names)
        return torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict,
               layout: Layout = WHOLE) -> tuple[dict, OptState]:
        """``layout``: where each parameter lives on a mesh (by default every
        tensor whole, one process)."""
        updates, new_groups = {}, {}
        group_grads = {
            g: [local(grads.get(n) if grads.get(n) is not None
                      else torch.zeros_like(local(params[n]))).float()
                for n in names] for g, names in state.names.items()}
        # clip by the global norm (of the group, or of every group), taken
        # before anything else; a frozen group's gradients count in the latter
        every = [t for gs in group_grads.values() for t in gs]
        factor = (self._clip_factor(every, [n for ns in state.names.values() for n in ns], layout)
                  if self.global_clip and every else None)
        for g, names in state.names.items():
            st = state.groups[g]
            if not names or g in self.frozen:
                new_groups[g] = st
                continue
            ps = [local(params[n]) for n in names]
            gs = group_grads[g]
            gs = torch._foreach_mul(gs, factor if factor is not None
                                    else self._clip_factor(gs, names, layout))
            mu = torch._foreach_mul(st.mu, self.b1)
            torch._foreach_add_(mu, gs, alpha=1 - self.b1)
            nu = torch._foreach_mul(st.nu, self.b2)
            torch._foreach_add_(nu, torch._foreach_mul(gs, gs), alpha=1 - self.b2)
            count = st.count + 1
            bc1 = float(_F(1) - _F(self.b1) ** _F(count))
            bc2 = float(_F(1) - _F(self.b2) ** _F(count))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(upd, [p.float() for p in ps], alpha=self.weight_decay)
            torch._foreach_mul_(upd, -self.lr[g](st.count))
            if state.lr_scale != 1.0:
                torch._foreach_mul_(upd, state.lr_scale)
            updates.update(zip(names, upd))
            new_groups[g] = GroupState(count, mu, nu)
        return updates, OptState(new_groups, state.lr_scale, state.names)


def local(t):
    """This rank's piece of ``t``: a DTensor's local shard (a view: writing
    it writes the parameter), any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def apply_updates(params: dict, updates: dict) -> None:
    """``params += updates`` in place (optax's ``apply_updates``)."""
    with torch.no_grad():
        names = list(updates)
        ps = [local(params[n]) for n in names]
        torch._foreach_add_(ps, [updates[n].to(p.dtype) for n, p in zip(names, ps)])


def make_optimizer(lr: LR = 1e-4, *, grad_clip: float = 10.0, weight_decay: float = 0.01,
                   b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6) -> Optimizer:
    """One clip + AdamW chain over every parameter, then ``lr_scale``."""
    return Optimizer({"all": lr}, lambda _n: "all", grad_clip=grad_clip,
                     weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


def make_multi_optimizer(lr, *, module_keys=("cfm", "length_regulator"),
                         grad_clip: float = 10.0, weight_decay: float = 0.01,
                         b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6) -> Optimizer:
    """A clip + AdamW chain per top-level module (clip norm per module), then
    ``lr_scale``. ``lr`` is one float / schedule or a dict by module key."""
    if not isinstance(lr, dict):
        lr = {k: lr for k in module_keys}
    return Optimizer(dict(lr), lambda n: n.split(".", 1)[0], grad_clip=grad_clip,
                     weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


V2_GROUPS = {"dit": "cfm", "cfm_reg": "cfm", "ar": "ar", "ar_reg": "ar"}


def make_v2_optimizer(lr: LR = 1e-4, *, train_cfm: bool = True, train_ar: bool = True,
                      grad_clip: float = 1000.0, weight_decay: float = 0.01, b1: float = 0.9,
                      b2: float = 0.98, eps: float = 1e-6) -> Optimizer:
    """The v2 trainer's chain: one clip by the global norm over every module,
    then an AdamW chain for the ``cfm`` modules (``dit``, ``cfm_reg``) and one
    for the ``ar`` modules (``ar``, ``ar_reg``); a branch left out of training
    (``train_cfm`` / ``train_ar`` False) is frozen, then ``lr_scale``."""
    frozen = tuple(g for g, on in (("cfm", train_cfm), ("ar", train_ar)) if not on)
    return Optimizer({"cfm": lr, "ar": lr}, lambda n: V2_GROUPS[n.split(".", 1)[0]],
                     grad_clip=grad_clip, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                     global_clip=True, frozen=frozen)


def get_lr_scale(state: OptState) -> float:
    return state.lr_scale


def set_lr_scale(state: OptState, value: float) -> OptState:
    return OptState(state.groups, float(value), state.names)


def global_norm(grads, layout: Layout = WHOLE, names=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (None counts as zero):
    the norm of the full tensors that the ranks' pieces make up, where
    ``layout`` (with the gradients' parameter ``names``, in order) says how
    each is cut; by default every gradient is whole."""
    grads = list(grads)
    names = [None] * len(grads) if names is None else names
    by_axes: dict = {}
    for n, g in zip(names, grads):
        if g is not None:
            by_axes.setdefault(layout.axes(n), []).append(local(g).float())
    norms = []
    for axes in sorted(by_axes):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(by_axes[axes])))
        group = layout.group(axes)
        norms.append(norm if group is None else all_reduce_sum(norm ** 2, group).sqrt())
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))
