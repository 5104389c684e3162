"""The single-GPU v1 training step (port of ``seedvc_tpu/train/step.py``).

``make_train_step`` builds ``step_fn(state, batch, key) -> (state, metrics)``:
the ``VCModel`` loss on the batch with the draws of ``draws_fn(key, shape,
device)``, its gradients, the optimizer's update applied in place to the
model's parameters, and the parameter EMA. With ``teacher_params`` it adds
0.5·MSE between the student's CFM output and a frozen teacher's on the same
inputs and draws. ``compute_dtype=torch.bfloat16`` casts the four big batch
tensors (``s_alt``, ``s_ori``, ``mels``, ``style``) to bf16, as the JAX step
does, while the master weights, the gradients, the loss reduction, F0 and the
lengths stay f32 / int; the layers then compute in the types the JAX
package's promotion gives (``nn.layers.Dense``).

Metrics are device tensors (``loss``, ``grad_norm`` of the unclipped
gradients), so a step reads nothing back from the device.

The JAX step is one SPMD program over a (data, model) mesh; multi-GPU
training (``shard_state``, FSDP, tensor parallelism) is not ported and
raises, naming ROADMAP queue 1 item 3c.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from seedvc_tpu_torch.models.vc import TrainDraws, VCModel, draw_train
from seedvc_tpu_torch.train.optim import Optimizer, OptState, apply_updates, global_norm
from seedvc_tpu_torch.weights import load_jax_params

CAST_KEYS = ("s_alt", "s_ori", "mels", "style")
MULTI_GPU = "multi-GPU training is not ported: ROADMAP queue 1 item 3c"

DrawsFn = Callable[[Any, tuple, torch.device], TrainDraws]


class TrainState(NamedTuple):
    """``params``: name -> the model's own parameters (f32 masters, updated in
    place); ``opt_state``; ``step`` (Python int); ``ema_params``: name -> f32
    copies, or None (EMA off)."""

    params: dict
    opt_state: OptState
    step: int
    ema_params: Optional[dict] = None


def init_state(model: VCModel, optimizer: Optimizer, ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    ema_params = ({n: p.detach().clone() for n, p in params.items()} if ema else None)
    return TrainState(params, optimizer.init(params), 0, ema_params)


def shard_state(*_args, **_kwargs):
    raise NotImplementedError(f"shard_state: {MULTI_GPU}")


def step_seed(key) -> int:
    """A 63-bit generator seed from a step key ``(seed, step)``."""
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def generator_draws(class_dropout_prob: float) -> DrawsFn:
    """The default ``draws_fn``: a ``torch.Generator`` on the batch's device
    seeded from the step key ``(seed, step)``, so a step's draws depend on the
    key alone (a resumed run draws what an uninterrupted one drew)."""
    def draws_fn(key, shape, device) -> TrainDraws:
        g = torch.Generator(device=device).manual_seed(step_seed(key))
        B, T, n_mels = shape
        return draw_train(g, B, T, n_mels, class_dropout_prob, device=device)

    return draws_fn


def _model_inputs(batch: dict, compute_dtype) -> tuple[tuple, dict]:
    if compute_dtype is not None:
        batch = {k: (v.to(compute_dtype) if k in CAST_KEYS else v) for k, v in batch.items()}
    args = (batch["s_alt"], batch["s_ori"], batch["mels"], batch["mel_lens"], batch["style"])
    kw = dict(f0=batch.get("f0"), s_lens=batch.get("s_lens"), f0_lens=batch.get("f0_lens"))
    return args, kw


def _draws_to(draws: TrainDraws, device) -> TrainDraws:
    return TrainDraws(*(None if d is None else d.to(device) for d in draws))


def make_train_step(model: VCModel, optimizer: Optimizer, *, teacher_params=None,
                    distill_weight: float = 0.5, weight_ema_decay: float = 0.0,
                    compute_dtype: Optional[torch.dtype] = None,
                    draws_fn: Optional[DrawsFn] = None):
    """Build ``step_fn(state, batch, key) -> (state, metrics)``. ``batch``
    holds the trainer's prepared tensors on the model's device; ``key`` is
    what ``draws_fn`` takes (the trainer passes ``(seed, step)``).
    ``teacher_params``: a frozen teacher's flax tree (same architecture)."""
    if draws_fn is None:
        draws_fn = generator_draws(model.mp.DiT.class_dropout_prob)
    teacher = None
    if teacher_params is not None:
        device = next(model.parameters()).device
        teacher = load_jax_params(VCModel(model.mp), teacher_params)
        teacher.requires_grad_(False).eval().to(device)

    def step_fn(state: TrainState, batch: dict, key):
        args, kw = _model_inputs(batch, compute_dtype)
        mels = batch["mels"]
        draws = _draws_to(draws_fn(key, tuple(mels.shape), mels.device), mels.device)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, out = model(*args, draws, **kw)
            if teacher is not None:
                with torch.no_grad():
                    _, t_out = teacher(*args, draws, **kw)
                loss = loss + distill_weight * torch.mean((out - t_out) ** 2)
            loss.backward()
        grads = {n: p.grad for n, p in state.params.items()}
        gnorm = global_norm(grads.values())
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        ema = state.ema_params
        if weight_ema_decay > 0 and ema is not None:
            with torch.no_grad():
                names = list(ema)
                e = [ema[n] for n in names]
                torch._foreach_mul_(e, weight_ema_decay)
                torch._foreach_add_(e, [state.params[n].detach() for n in names],
                                    alpha=1 - weight_ema_decay)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        return TrainState(state.params, opt_state, state.step + 1, ema), metrics

    return step_fn


def make_eval_step(model: VCModel, draws_fn: Optional[DrawsFn] = None):
    """``eval_fn(params, batch, key) -> loss``: the loss alone, without
    gradients, with ``params`` (name -> tensor, e.g. ``state.params`` or the
    EMA) in place of the model's own, and no compute-dtype cast."""
    if draws_fn is None:
        draws_fn = generator_draws(model.mp.DiT.class_dropout_prob)

    @torch.no_grad()
    def eval_fn(params: dict, batch: dict, key) -> torch.Tensor:
        args, kw = _model_inputs(batch, None)
        mels = batch["mels"]
        draws = _draws_to(draws_fn(key, tuple(mels.shape), mels.device), mels.device)
        loss, _ = functional_call(model, params, (*args, draws), kw)
        return loss

    return eval_fn
