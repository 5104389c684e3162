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
gradients), so a step reads nothing back from the device, and ``span``: the
step's :class:`~seedvc_tpu_torch.core.profiling.Span` (``train.step``, its
host wall, and on cuda a pair of timing events at its first and last launch,
read once they have completed). Inside it the ``torch.profiler`` spans
``train.forward``, ``train.backward``, ``train.optimizer`` and ``train.ema``.

The JAX step is one SPMD program over a (data, model) mesh, the
parallelism a layout that XLA's partitioner turns into collectives. Here
each rank is a process (``parallel/*``): :func:`shard_state` splits the
model's attention and FFN weights over ``model`` (tensor parallel, heads
aligned; ``parallel/sharding.py``) and, with ``fsdp``, hands the parameters
that the rules scatter over ``data`` to FSDP2 (``fully_shard`` over the
mesh's ``data`` dim, each on the dimension the rules name); the AdamW
moments and the EMA are cut the same way. :func:`make_sharded_train_step`
runs each rank on its rows of the global batch with its rows of the global
batch's draws, takes the loss's mean over ``data`` (every rank holds the
same number of rows), averages the gradients over ``data`` and clips by the
norm of the full gradients, so a step on any mesh and either ``fsdp`` gives
the one-process step's numbers on the same global batch and draws.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from seedvc_tpu_torch.core.profiling import Span, annotate
from seedvc_tpu_torch.models.vc import TrainDraws, VCModel, draw_train
from seedvc_tpu_torch.parallel.collectives import pmean
from seedvc_tpu_torch.parallel.mesh import AXES, Mesh, data_rows, replicate, set_mesh, shard_batch
from seedvc_tpu_torch.parallel.sharding import (WHOLE, Layout, ParamLayout, TensorParallel,
                                                module_specs)
from seedvc_tpu_torch.train.optim import (GroupState, Optimizer, OptState, apply_updates,
                                          global_norm, local)
from seedvc_tpu_torch.weights import load_jax_params

CAST_KEYS = ("s_alt", "s_ori", "mels", "style")

DrawsFn = Callable[[Any, tuple, torch.device], TrainDraws]


class TrainState(NamedTuple):
    """``params``: name -> the model's own parameters (f32 masters, updated in
    place); ``opt_state``; ``step`` (Python int); ``ema_params``: name -> f32
    copies, or None (EMA off); ``layout``: where each of them lives on a mesh
    (by default every tensor whole, one process)."""

    params: dict
    opt_state: OptState
    step: int
    ema_params: Optional[dict] = None
    layout: Layout = WHOLE


def init_state(model: VCModel, optimizer: Optimizer, ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    ema_params = ({n: p.detach().clone() for n, p in params.items()} if ema else None)
    return TrainState(params, optimizer.init(params), 0, ema_params)


def _fully_shard():
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:  # torch < 2.6
        from torch.distributed._composable.fsdp import fully_shard
    return fully_shard


def shard_model(model: torch.nn.Module, mesh: Mesh, fsdp: bool = False,
                fsdp_min_elems: int = 65536) -> Layout:
    """Lay ``model``'s parameters on ``mesh`` in place and return their
    :class:`Layout`: the first rank's values on every rank; the tensor-
    parallel modules cut to this rank's part where the rules split all their
    weights over ``model`` and their heads divide; then, with ``fsdp``, FSDP2
    over the ``data`` dim for the parameters that the rules scatter over
    ``data`` (those of ``fsdp_min_elems`` elements or more, JAX's floor),
    except any that a module names in ``fsdp_whole`` (read outside its
    forward)."""
    group = mesh.all_group()
    if group is not None:
        import torch.distributed as dist

        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, src=mesh.first_rank, group=group)
    specs = module_specs(model, mesh, fsdp_axis=AXES.data if fsdp else None,
                         fsdp_min_elems=fsdp_min_elems)
    entries: dict = {}
    n_model = mesh.size(AXES.model)
    if n_model > 1:
        for prefix, mod in list(model.named_modules()):
            if not isinstance(mod, TensorParallel):
                continue
            splits = {f"{prefix}.{k}": v for k, v in mod.tp_splits().items()}
            if mod.tp_divides(n_model) and all(AXES.model in specs[n][0] for n in splits):
                entries.update((n, ParamLayout(tp=v)) for n, v in splits.items())
                mod.shard_model_(mesh.index(AXES.model), n_model, mesh.group(AXES.model))
    if fsdp and mesh.device_mesh is not None:
        from torch.distributed.tensor import Shard

        whole = {f"{prefix}.{n}" if prefix else n for prefix, mod in model.named_modules()
                 for n in getattr(mod, "fsdp_whole", ())}
        dims = {n: perm[spec.index(AXES.data)] for n, (spec, perm) in specs.items()
                if AXES.data in spec and n not in whole}
        for n, d in dims.items():
            entries[n] = replace(entries.get(n, ParamLayout()), fsdp_dim=d)
        named = dict(model.named_parameters())
        dim_of = {id(named[n]): d for n, d in dims.items()}
        kw = dict(mesh=mesh.device_mesh[AXES.data],
                  ignored_params={p for n, p in named.items() if n not in dims},
                  shard_placement_fn=lambda p: Shard(dim_of.get(id(p), 0)))
        fully_shard = _fully_shard()
        # a unit per module that owns a scattered parameter itself, deepest
        # first: its forward gathers what it computes with, whichever module
        # calls it (the v2 trainer calls the submodules, not the root)
        for _, mod in reversed(list(model.named_modules())):
            if any(id(p) in dim_of for p in mod.parameters(recurse=False)):
                fully_shard(mod, **kw)
    return Layout(mesh, entries)


def shard_opt_state(opt: OptState, layout: Layout) -> OptState:
    """``opt``'s moments (full tensors) cut to this rank's pieces."""
    groups = {g: GroupState(st.count, [layout.scatter(n, m) for n, m in zip(opt.names[g], st.mu)],
                            [layout.scatter(n, m) for n, m in zip(opt.names[g], st.nu)])
              if st.mu else st for g, st in opt.groups.items()}
    return OptState(groups, opt.lr_scale, opt.names)


def shard_state(state: TrainState, mesh: Mesh, fsdp: bool = False,
                fsdp_min_elems: int = 65536, *, model: torch.nn.Module) -> TrainState:
    """Place a :class:`TrainState` of ``model`` (whole tensors) on ``mesh``:
    :func:`shard_model` on the model whose parameters ``state.params`` are,
    and the AdamW moments and the EMA cut as the parameters. ``fsdp=True``
    scatters parameters, moments and EMA over ``data`` (ZeRO-3). The port's
    parameters live in the module, so it takes the module (``model``)."""
    layout = shard_model(model, mesh, fsdp, fsdp_min_elems)
    ema = state.ema_params
    if ema is not None:
        ema = {n: layout.scatter(n, t) for n, t in replicate(mesh, ema).items()}
    return TrainState(dict(model.named_parameters()), shard_opt_state(state.opt_state, layout),
                      state.step, ema, layout)


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
        mels = batch["mels"]
        span = Span("train.step", device=mels.device)
        with annotate("train.forward"):
            args, kw = _model_inputs(batch, compute_dtype)
            draws = _draws_to(draws_fn(key, tuple(mels.shape), mels.device), mels.device)
            model.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss, out = model(*args, draws, **kw)
                if teacher is not None:
                    with torch.no_grad():
                        _, t_out = teacher(*args, draws, **kw)
                    loss = loss + distill_weight * torch.mean((out - t_out) ** 2)
        with annotate("train.backward"):
            loss.backward()
        with annotate("train.optimizer"):
            grads = {n: p.grad for n, p in state.params.items()}
            gnorm = global_norm(grads.values())
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            apply_updates(state.params, updates)
        ema = state.ema_params
        if weight_ema_decay > 0 and ema is not None:
            with annotate("train.ema"):
                update_ema(ema, state.params, weight_ema_decay)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "span": span.close()}
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


def _shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of the batch-axis tensors; 0-d tensors (the true
    lengths) as they are."""
    return shard_batch(mesh, batch)


def draw_rows(draws: NamedTuple, mesh: Mesh, n: int):
    """This rank's rows of draws made for the global batch of ``n`` rows
    (0-d draws, whole-batch ones, as they are)."""
    rows = data_rows(mesh, n)
    return type(draws)(*(d if d is None or d.ndim == 0 else d[rows] for d in draws))


def average_gradients(grads: dict, layout: Layout) -> None:
    """Mean over ``data`` of the gradients that FSDP did not already reduce,
    in place, in one collective."""
    group = layout.mesh.group(AXES.data)
    if group is None:
        return
    names = [n for n, g in grads.items() if g is not None and layout.of(n).fsdp_dim is None]
    if not names:
        return
    import torch.distributed as dist

    flat = torch.cat([grads[n].reshape(-1) for n in names])
    dist.all_reduce(flat, group=group)
    flat /= layout.mesh.size(AXES.data)
    for n, piece in zip(names, flat.split([grads[n].numel() for n in names])):
        grads[n].copy_(piece.view_as(grads[n]))


def update_ema(ema: dict, params: dict, decay: float) -> None:
    with torch.no_grad():
        names = list(ema)
        e = [ema[n] for n in names]
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, [local(params[n]).detach() for n in names], alpha=1 - decay)


def make_sharded_train_step(model: VCModel, optimizer: Optimizer, mesh: Mesh, *,
                            teacher_params=None, distill_weight: float = 0.5,
                            weight_ema_decay: float = 0.0,
                            compute_dtype: Optional[torch.dtype] = None,
                            draws_fn: Optional[DrawsFn] = None):
    """Build ``step_fn(state, batch, key, local_rows=False) -> (state,
    metrics)`` over ``mesh`` for a state from :func:`shard_state`. ``batch``
    is the global batch (each rank takes its rows), or this rank's rows
    already with ``local_rows=True``; ``draws_fn`` makes the global batch's
    draws from ``key`` and each rank takes its rows, so every mesh draws what
    one process draws. The teacher (a flax tree) stays whole on every rank.
    Metrics are the global batch's."""
    if draws_fn is None:
        draws_fn = generator_draws(model.mp.DiT.class_dropout_prob)
    teacher = None
    if teacher_params is not None:
        device = next(model.parameters()).device
        teacher = load_jax_params(VCModel(model.mp), teacher_params)
        teacher.requires_grad_(False).eval().to(device)
    g_data, n_data = mesh.group(AXES.data), mesh.size(AXES.data)

    def step_local(state: TrainState, batch: dict, key):
        layout = state.layout
        mels = batch["mels"]
        span = Span("train.step", device=mels.device)
        with annotate("train.forward"):
            args, kw = _model_inputs(batch, compute_dtype)
            B, T, C = mels.shape
            draws = _draws_to(draws_fn(key, (B * n_data, T, C), mels.device), mels.device)
            draws = draw_rows(draws, mesh, B * n_data)
            model.zero_grad(set_to_none=True)
            with torch.enable_grad(), set_mesh(mesh, AXES.data):
                loss, out = model(*args, draws, **kw)
                if teacher is not None:
                    with torch.no_grad():
                        _, t_out = teacher(*args, draws, **kw)
                    loss = loss + distill_weight * torch.mean((out - t_out) ** 2)
                loss = pmean(loss, g_data)
        with annotate("train.backward"), torch.enable_grad(), set_mesh(mesh, AXES.data):
            loss.backward()
        with annotate("train.optimizer"):
            names = list(state.params)
            grads = {n: state.params[n].grad for n in names}
            average_gradients(grads, layout)
            gnorm = global_norm(grads.values(), layout, names)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params, layout)
            apply_updates(state.params, updates)
        if weight_ema_decay > 0 and state.ema_params is not None:
            with annotate("train.ema"):
                update_ema(state.ema_params, state.params, weight_ema_decay)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "span": span.close()}
        return (TrainState(state.params, opt_state, state.step + 1, state.ema_params, layout),
                metrics)

    def run(state: TrainState, batch: dict, key, local_rows: bool = False):
        return step_local(state, batch if local_rows else _shard_batch(batch, mesh), key)

    return run


def make_sharded_eval_step(model: VCModel, mesh: Mesh, draws_fn: Optional[DrawsFn] = None):
    """``eval_fn(params, batch, key, local_rows=False) -> loss``: the global
    batch's loss without gradients or cast, each rank on its rows. ``params``
    are the model's own (``state.params``: it runs the model as it is) or,
    off FSDP, any tensors named like them."""
    if draws_fn is None:
        draws_fn = generator_draws(model.mp.DiT.class_dropout_prob)
    g_data, n_data = mesh.group(AXES.data), mesh.size(AXES.data)

    @torch.no_grad()
    def eval_fn(params: dict, batch: dict, key, local_rows: bool = False) -> torch.Tensor:
        if not local_rows:
            batch = _shard_batch(batch, mesh)
        args, kw = _model_inputs(batch, None)
        mels = batch["mels"]
        B, T, C = mels.shape
        draws = _draws_to(draws_fn(key, (B * n_data, T, C), mels.device), mels.device)
        draws = draw_rows(draws, mesh, B * n_data)
        own = all(params.get(n) is p for n, p in model.named_parameters())
        with set_mesh(mesh, AXES.data):
            if own:
                loss, _ = model(*args, draws, **kw)
            else:
                loss, _ = functional_call(model, params, (*args, draws), kw)
        return pmean(loss, g_data)

    return eval_fn


def gather_full(layout: Layout, tensors: dict) -> dict:
    """name -> the full tensor that the ranks' pieces make up (collective)."""
    return {n: layout.gather(n, local(t)) for n, t in tensors.items()}


def full_opt_state(opt: OptState, layout: Layout) -> OptState:
    """``opt`` with whole moments (collective)."""
    groups = {g: GroupState(st.count, [layout.gather(n, m) for n, m in zip(opt.names[g], st.mu)],
                            [layout.gather(n, m) for n, m in zip(opt.names[g], st.nu)])
              for g, st in opt.groups.items()}
    return OptState(groups, opt.lr_scale, opt.names)
