"""The optimizer and LR schedule of v1 fine-tuning, written to optax's
semantics (port of ``seedvc_tpu/train/optim.py``, one process).

``make_optimizer`` is ``optax.chain(clip_by_global_norm(grad_clip),
adamw(lr, b1, b2, eps, weight_decay))`` followed by the trailing runtime
``lr_scale`` of ``with_lr_scale``. What the update does, as optax does it:

- the global norm of the gradients is taken first; above ``grad_clip``
  every gradient is scaled by ``grad_clip / norm``;
- Adam moments ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g²``, a
  step count incremented before the bias corrections ``1 - b^count``;
- ``update = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * param``, with the
  parameter taken before the update (decoupled decay);
- times ``-lr(count)``, where the schedule reads the count as it was before
  this update (0 on the first step), then times the runtime ``lr_scale``.

A parameter without a gradient (an unused branch) is updated as if its
gradient were zero, as optax updates every leaf of the tree. The schedules
are computed in float32, as jnp computes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Union

import numpy as np
import torch

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
    """A clip + AdamW chain over every parameter, then ``lr_scale``.
    ``init(params)`` and ``update(grads, state, params)`` take dicts of
    name -> tensor (``dict(module.named_parameters())``); ``update`` returns
    (updates, new state), the updates to be added to the parameters."""

    def __init__(self, lr: LR, *, grad_clip: float, weight_decay: float, b1: float, b2: float,
                 eps: float):
        self.lr = lr if callable(lr) else (lambda _c, _v=lr: _v)
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> OptState:
        names = list(params)
        zeros = lambda: [torch.zeros_like(params[n], dtype=torch.float32)  # noqa: E731
                         for n in names]
        return OptState({"all": GroupState(0, zeros(), zeros())}, 1.0, {"all": names})

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict) -> tuple[dict, OptState]:
        names, st = state.names["all"], state.groups["all"]
        gs = [(grads.get(n) if grads.get(n) is not None
               else torch.zeros_like(params[n])).float() for n in names]
        norm = global_norm(gs)
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        gs = torch._foreach_mul(gs, factor)
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
        torch._foreach_add_(upd, [params[n].float() for n in names], alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr(st.count))
        if state.lr_scale != 1.0:
            torch._foreach_mul_(upd, state.lr_scale)
        return (dict(zip(names, upd)),
                OptState({"all": GroupState(count, mu, nu)}, state.lr_scale, state.names))


def apply_updates(params: dict, updates: dict) -> None:
    """``params += updates`` in place (optax's ``apply_updates``)."""
    with torch.no_grad():
        names = list(updates)
        ps = [params[n] for n in names]
        torch._foreach_add_(ps, [updates[n].to(p.dtype) for n, p in zip(names, ps)])


def make_optimizer(lr: LR = 1e-4, *, grad_clip: float = 10.0, weight_decay: float = 0.01,
                   b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6) -> Optimizer:
    """One clip + AdamW chain over every parameter, then ``lr_scale``."""
    return Optimizer(lr, grad_clip=grad_clip, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (None counts as zero)."""
    gs = [g.float() for g in grads if g is not None]
    if not gs:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
