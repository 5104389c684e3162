"""Conditional flow matching: the OT-CFM training loss and the Euler ODE
sampler (port of ``seedvc_tpu/models/cfm.py``).

Training (:meth:`CFM.forward`): straight-path interpolant
``y = (1-(1-σ)t)·z + t·x1`` with target velocity ``u = x1 - (1-σ)·z``, the
prompt region of x1 spliced in as the prompt and zeroed in y, the loss taken
over [prompt_len, x_len) only and reduced in f32. The time ``t``, the noise
``z`` and the classifier-free dropout mask are arguments.

Inference: fixed-step Euler over a linear ``t_span = linspace(0, 1, n+1)``
(or v2's cosine schedule); classifier-free guidance stacks the branches of
:func:`cfg_branches` (v1: the conditional batch over a null batch of zeroed
prompt/style/mu) and combines their estimates with Python-float weights
(v1: ``(1+r)·cond − r·uncond``); the prompt region of x is re-zeroed every
step. The initial noise is an argument. ``shard_axis`` splits the CFG-stacked
batch over a mesh axis: each rank runs the estimator on its rows and the
ranks gather the velocity before the combination. ``seq_shard_axis`` splits
time over a mesh axis (:class:`~seedvc_tpu_torch.parallel.mesh.SeqShard`):
each rank runs the estimator on its time rows, the DiT's attention gathers
keys and values and its convolutions exchange halos, and the velocity is
gathered over time, then over the stack. Each Euler step is a
``cfm.step`` span of a ``torch.profiler`` trace and each estimator call in
it a ``dit.estimate`` span.

One step's math is :func:`euler_step`: :func:`euler_solve` (and v2's
``models/cfm_v2.py::euler_solve_multicfg``) calls it in one Python loop,
and :class:`EulerGraph` captures it once per sampler shape and CFG layout
as a CUDA graph that it replays every step (one device, no mesh axis), for
v1's layout or any other ``cfg_branches`` gives.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from seedvc_tpu_torch.core.config import ModelParams
from seedvc_tpu_torch.core.profiling import annotate
from seedvc_tpu_torch.models.dit import DiT
from seedvc_tpu_torch.ops import launches
from seedvc_tpu_torch.parallel.collectives import gather_rows, row_split
from seedvc_tpu_torch.parallel.mesh import SeqShard, current_mesh, seq_shard_block

SIGMA_MIN = 1e-6


class StackShard:
    """This rank's rows of an ``n``-row CFG stack split over mesh axis
    ``axis`` (of the innermost ``set_mesh`` block; XLA's uneven split:
    ceil(n / ranks) rows a rank, the last ones short), and the gather of the
    estimator's output back to all ``n`` rows. ``axis=None``: every row."""

    def __init__(self, axis: Optional[str], n: int):
        self.n, self.group, self.rows = n, None, slice(0, n)
        if axis is not None:
            mesh = current_mesh(axis)
            self.group = mesh.group(axis)
            self.rows = row_split(n, mesh.size(axis), mesh.index(axis))

    def take(self, t):
        return None if t is None else t[self.rows]

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        return gather_rows(v, self.group, self.n)


def time_shard(axis: Optional[str], T: int) -> Optional[SeqShard]:
    """The split of the sampler's T time rows over ``axis`` (None: whole)."""
    return None if axis is None else SeqShard.over(axis, T)


def estimate_rows(estimate_fn: Callable, seq: Optional[SeqShard], shard: StackShard,
                  xx: torch.Tensor, t, est: tuple, est_args: tuple) -> torch.Tensor:
    """One estimator call on this rank's stack rows and time rows of ``xx``
    (its time rows already taken; ``est`` = (prompt, lens, style, mu), this
    rank's rows) at time ``t`` (a float, or a 0-d tensor in mu's dtype), the
    velocity gathered over time, then over the stack."""
    n_local = xx.shape[0]
    prompt, lens, style, mu = est
    if n_local:
        tt = (t.expand(n_local) if isinstance(t, torch.Tensor)
              else torch.full((n_local,), t, dtype=mu.dtype, device=mu.device))
        with seq_shard_block(seq):
            v = estimate_fn(xx, prompt, lens, tt, style, mu, *est_args)
    else:  # more ranks than rows: this one only takes part in the gathers
        v = torch.zeros_like(xx)
    if seq is not None:
        v = seq.gather(v)
    return shard.gather(v)


class CFM(nn.Module):
    """Owns the DiT estimator; ``forward`` is the training loss, ``estimate``
    the raw vector field."""

    def __init__(self, mp: ModelParams):
        super().__init__()
        self.mp = mp
        self.estimator = DiT(mp)

    def forward(self, x1: torch.Tensor, x_lens: torch.Tensor, prompt_lens: torch.Tensor,
                mu: torch.Tensor, style: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                cond_drop: Optional[torch.Tensor] = None):
        """OT-CFM loss. x1: (B, T, C) target mel; x_lens / prompt_lens: (B,)
        ints; mu: (B, T, D) regulated content; style: (B, S); t: (B,) f32 in
        [0, 1); noise: (B, T, C), taken in x1's dtype; cond_drop: (B,) 1.0 =
        the null branch, or None. Returns (loss, estimator output + (1-σ)·z)."""
        B, T, C = x1.shape
        dc = self.mp.DiT
        z = noise.to(x1.dtype)
        tb = t[:, None, None].to(x1.dtype)
        y = (1 - (1 - SIGMA_MIN) * tb) * z + tb * x1
        u = x1 - (1 - SIGMA_MIN) * z

        pos = torch.arange(T, device=x1.device)[None, :, None]
        in_prompt = pos < prompt_lens[:, None, None]
        prompt = torch.where(in_prompt, x1, torch.zeros_like(x1))
        y = torch.where(in_prompt, torch.zeros_like(y), y)
        if dc.zero_prompt_speech_token:
            mu = torch.where(in_prompt, torch.zeros_like(mu), mu)
        if cond_drop is not None:
            cond_drop = cond_drop.to(x1.dtype)

        out = self.estimator(y, prompt, x_lens, t, style, mu, cond_drop=cond_drop)

        # per-sample mean over the valid region's elements, then the batch mean
        valid = ((~in_prompt) & (pos < x_lens[:, None, None])).to(torch.float32)
        diff = (out - u).to(torch.float32)
        per = diff * diff if self.mp.reg_loss_type == "l2" else diff.abs()
        denom = torch.clamp(valid.sum(dim=(1, 2)) * C, min=1.0)
        loss = ((per * valid).sum(dim=(1, 2)) / denom).mean()
        return loss, out + (1 - SIGMA_MIN) * z

    def estimate(self, x, prompt_x, x_lens, t, style, cond, static_cond=None):
        return self.estimator(x, prompt_x, x_lens, t, style, cond, static_cond=static_cond)

    def precompute_cond(self, x, prompt_x, x_lens, style, cond):
        t0 = torch.zeros(x.shape[0], device=x.device)
        return self.estimator(x, prompt_x, x_lens, t0, style, cond, return_static=True)


def cosine_t_span(n_timesteps: int) -> torch.Tensor:
    """v2's cosine schedule ``t - (cos(pi t / 2) - 1 + t)``: (n + 1,) f32 on
    the CPU."""
    t = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=torch.float32)
    return t - (torch.cos(math.pi / 2 * t) - 1 + t)


def time_span(n_timesteps: int, t_scheduler: str = "linear") -> torch.Tensor:
    """The sampler's (n + 1,) f32 times on the CPU: ``linspace(0, 1, n + 1)``
    for ``linear``, :func:`cosine_t_span` for ``cosine``."""
    if t_scheduler not in ("linear", "cosine"):
        raise ValueError(f"unknown t_scheduler {t_scheduler!r}")
    return (cosine_t_span(n_timesteps) if t_scheduler == "cosine"
            else torch.linspace(0.0, 1.0, n_timesteps + 1))


def cfg_branches(prompt_x, style, mu, cfg_rates: Sequence[float], random_voice: bool):
    """[(prompt, style, mu) per branch], weights: the five layouts of the CFG
    stack for (r0, r1) = (intelligibility, similarity); v1's is (r, 0)."""
    r0, r1 = float(cfg_rates[0]), float(cfg_rates[1])
    if not random_voice and r0 == 0 and r1 == 0:
        return [(prompt_x, style, mu)], (1.0,)
    zp, zs, zm = torch.zeros_like(prompt_x), torch.zeros_like(style), torch.zeros_like(mu)
    if random_voice:  # [text-only / unconditional]
        return [(zp, zs, mu), (zp, zs, zm)], (1.0 + r0, -r0)
    if r0 == 0:  # [full / text-only]
        return [(prompt_x, style, mu), (zp, zs, mu)], (1.0 + r1, -r1)
    if r1 == 0:  # [full / unconditional]
        return [(prompt_x, style, mu), (zp, zs, zm)], (1.0 + r0, -r0)
    # [full / text-only / unconditional]
    return ([(prompt_x, style, mu), (zp, zs, mu), (zp, zs, zm)], (1.0 + r0 + r1, -r1, -r0))


def _v1_branches(cfg_rate: float) -> Callable:
    """``(1+r)·cond − r·uncond`` for r > 0, ``cond`` alone for r <= 0."""
    return functools.partial(cfg_branches, cfg_rates=(max(cfg_rate, 0.0), 0.0),
                             random_voice=False)


def sampler_inputs(noise, mu, x_lens, prompt, prompt_len: int, style, branches: Callable,
                   temperature: float = 1.0) -> tuple:
    """x at t = 0 (the noise scaled, zero in the prompt), the (1, T, 1)
    prompt mask, the estimator's inputs (prompt, lens, style, mu), the
    branches of ``branches(prompt_x, style, mu)`` stacked, and their weights."""
    T = mu.shape[1]
    noise = noise * temperature
    in_prompt = (torch.arange(T, device=mu.device) < prompt_len)[None, :, None]
    prompt_x = torch.where(in_prompt, prompt, torch.zeros_like(prompt))
    x = torch.where(in_prompt, torch.zeros_like(noise), noise)
    rows, weights = branches(prompt_x, style, mu)
    if len(rows) == 1:
        return x, in_prompt, (prompt_x, x_lens, style, mu), weights
    est_prompt, est_style, est_mu = (torch.cat([b[i] for b in rows], 0) for i in range(3))
    est_lens = None if x_lens is None else torch.cat([x_lens] * len(rows), 0)
    return x, in_prompt, (est_prompt, est_lens, est_style, est_mu), weights


def precompute_args(precompute_fn: Optional[Callable], est: tuple, n_mels: int,
                    seq: Optional[SeqShard] = None) -> tuple:
    """``(static_cond,)`` from ``precompute_fn`` on the estimator's inputs
    ``est`` (this rank's rows), or () without one or without rows."""
    prompt, lens, style, mu = est
    if precompute_fn is None or not mu.shape[0]:
        return ()
    x_shape = (mu.shape[0], mu.shape[1], n_mels)
    with seq_shard_block(seq):
        return (precompute_fn(torch.zeros(x_shape, dtype=mu.dtype, device=mu.device),
                              prompt, lens, style, mu),)


def euler_step(estimate_fn: Callable, x: torch.Tensor, t, dt, est: tuple, est_args: tuple,
               in_prompt: torch.Tensor, weights: tuple, shard: StackShard,
               seq: Optional[SeqShard] = None, keep: Optional[tuple] = None) -> torch.Tensor:
    """One Euler step: the estimator on the CFG stack (this rank's rows),
    ``w0·v0 + w1·v1 (+ w2·v2)`` with the Python-float ``weights``, the f32
    update ``x + dt·v`` and the prompt re-zeroed; returns the new x. ``t``
    and ``dt`` are Python floats (the eager loop of :func:`euler_solve`) or
    0-d device tensors, ``t`` in the estimator's dtype and ``dt`` in f32 (the
    static inputs of :class:`EulerGraph`): the same numbers either way.
    ``keep``: buffers for the state and the combined estimate."""
    n_br = len(weights)
    xx = shard.take(torch.cat([x] * n_br, 0) if n_br > 1 else x)
    if seq is not None:
        xx = seq.take(xx)
    with annotate("dit.estimate"):
        v = estimate_rows(estimate_fn, seq, shard, xx, t, est, est_args)
    if n_br > 1:
        parts = v.chunk(n_br, dim=0)
        v = weights[0] * parts[0]
        for w, part in zip(weights[1:], parts[1:]):
            v = v + w * part
    if keep is not None:
        keep[0].copy_(x)
        keep[1].copy_(v)
    x = (x.float() + dt * v.float()).to(x.dtype)
    return torch.where(in_prompt, torch.zeros_like(x), x)


def _euler_loop(estimate_fn: Callable, noise: torch.Tensor, mu: torch.Tensor,
                x_lens: Optional[torch.Tensor], prompt: torch.Tensor, prompt_len, style,
                n_timesteps: int, branches: Callable, precompute_fn: Optional[Callable],
                temperature: float, t_scheduler: str, shard_axis: Optional[str],
                seq_shard_axis: Optional[str], keep: Optional[tuple] = None) -> torch.Tensor:
    """The eager loop of :func:`euler_solve` and v2's ``euler_solve_multicfg``;
    ``keep``: two (n_timesteps, B, T, n_mels) buffers, row i step i's."""
    t_span = time_span(n_timesteps, t_scheduler)
    seq = time_shard(seq_shard_axis, mu.shape[1])
    x, in_prompt, est, weights = sampler_inputs(noise, mu, x_lens, prompt, prompt_len, style,
                                                branches, temperature)
    shard = StackShard(shard_axis, est[3].shape[0])
    prompt_x, lens, style_x, mu_x = (shard.take(t) for t in est)
    if seq is not None:
        prompt_x, mu_x = seq.take(prompt_x), seq.take(mu_x)
    est = (prompt_x, lens, style_x, mu_x)
    est_args = precompute_args(precompute_fn, est, noise.shape[-1], seq)
    for i in range(n_timesteps):
        # trace-only spans (no events), so a graph capture may run them
        with annotate("cfm.step"):
            x = euler_step(estimate_fn, x, float(t_span[i]), float(t_span[i + 1] - t_span[i]),
                           est, est_args, in_prompt, weights, shard, seq,
                           None if keep is None else (keep[0][i], keep[1][i]))
    return x


@torch.no_grad()
def euler_solve(estimate_fn: Callable, noise: torch.Tensor, mu: torch.Tensor,
                x_lens: Optional[torch.Tensor], prompt: torch.Tensor, prompt_len: int,
                style: torch.Tensor, n_timesteps: int, cfg_rate: float = 0.7,
                precompute_fn: Optional[Callable] = None, temperature: float = 1.0,
                t_scheduler: str = "linear", shard_axis: Optional[str] = None,
                seq_shard_axis: Optional[str] = None) -> torch.Tensor:
    """Euler CFG sampler; ``estimate_fn(x, prompt_x, x_lens, t, style, mu[,
    static_cond]) -> v``.

    noise: (B, T, n_mels) initial noise in mu's dtype (scaled by
    ``temperature``); mu: (B, T, D); x_lens: (B,) or None; prompt: (B, T,
    n_mels) zero past prompt_len. ``t_scheduler``: ``linear`` or ``cosine``
    (:func:`cosine_t_span`). ``precompute_fn(x, prompt_x,
    x_lens, style, mu) -> static_cond`` hoists the step-invariant
    conditioning out of the loop. ``shard_axis``: split the CFG-stacked batch
    over that axis of the ``set_mesh`` mesh (each rank runs the estimator on
    its rows; every rank returns the whole result). ``seq_shard_axis``: split
    time over that axis (composes with ``shard_axis`` on the other one); each
    rank's estimator sees its rows of x, the prompt and mu, at their global
    positions, and ``precompute_fn`` runs on them.
    Returns the generated mel (B, T, n_mels); the prompt region holds zeros.
    """
    return _euler_loop(estimate_fn, noise, mu, x_lens, prompt, prompt_len, style, n_timesteps,
                       _v1_branches(cfg_rate), precompute_fn, temperature, t_scheduler,
                       shard_axis, seq_shard_axis)


@dataclass
class StepGraph:
    """One captured Euler step: its static buffers (the state ``x``, updated
    in place, ``t``, ``dt`` and the sampler's inputs by name), its replay,
    and what one replay launches of each kernel (as ``ops/launches.py``
    counts them)."""
    bufs: dict
    replay: Callable[[], None]
    launches: dict


MAX_GRAPHS = 8  # a 30 s window's five contexts at one CFG layout, and room
KEPT = ("keep.x", "keep.v")  # the static buffers of a step's kept state and estimate


class EulerGraph:
    """:func:`euler_solve` (or, given ``branches``, the loop v2's
    ``euler_solve_multicfg`` runs) on one device and no mesh axis, each
    Euler step replayed from a CUDA graph: ``sampler(noise, mu, x_lens,
    prompt, prompt_len, style, n_timesteps, cfg_rate)`` returns what
    ``euler_solve(estimate_fn, ..., precompute_fn=precompute_fn)`` returns,
    bit for bit (the same kernels in the same order). ``branches``: the CFG
    layout ``_euler_loop`` takes, in place of ``cfg_rate``'s; ``keep``: two
    (n_timesteps, B, T, n_mels) buffers, row i step i's state and combined
    estimate, as ``_euler_loop`` fills them.

    A call copies x at t = 0, the prompt mask, the CFG stack and the
    conditioning (``precompute_fn`` runs eagerly, once a call) into static
    buffers, then for each step copies t_i and dt_i from a device table of
    the schedule and replays the step, which updates x in place (and with
    ``keep`` writes the step's state and estimate into two static buffers,
    copied into the step's rows after the replay). A sampler shape's first
    call runs its first step eagerly on a side stream (kernel builds, cuBLAS
    and cuDNN plans, the RoPE tables), then captures the step as one CUDA
    graph with a memory pool of its own, and replays the rest. The returned
    mel is a copy, which no later replay overwrites.

    A graph is keyed by the shapes and dtypes of its inputs (the ``keep``
    rows among them) and the CFG weights of the layout; the prompt length is
    data (the mask). The ``MAX_GRAPHS`` most recently used are kept. The
    kernel counters count what the device ran (``ops/launches.py``): the
    capture, which runs nothing, adds nothing, and each replay what the
    captured step launches."""

    def __init__(self, estimate_fn: Callable, precompute_fn: Optional[Callable] = None):
        self.estimate_fn = estimate_fn
        self.precompute_fn = precompute_fn
        self.graphs: OrderedDict[tuple, StepGraph] = OrderedDict()  # oldest use first
        self._tables: dict = {}

    @torch.no_grad()
    def __call__(self, noise: torch.Tensor, mu: torch.Tensor, x_lens: Optional[torch.Tensor],
                 prompt: torch.Tensor, prompt_len: int, style: torch.Tensor, n_timesteps: int,
                 cfg_rate: float = 0.7, temperature: float = 1.0,
                 t_scheduler: str = "linear", branches: Optional[Callable] = None,
                 keep: Optional[tuple] = None) -> torch.Tensor:
        t_tab, dt_tab = self._schedule(n_timesteps, t_scheduler, mu.dtype, mu.device)
        x, in_prompt, est, weights = sampler_inputs(
            noise, mu, x_lens, prompt, prompt_len, style,
            _v1_branches(cfg_rate) if branches is None else branches, temperature)
        if not n_timesteps:
            return x
        inputs = dict(zip(("x", "in_prompt", "prompt", "lens", "style", "mu"),
                          (x, in_prompt, *est)))
        for args in precompute_args(self.precompute_fn, est, noise.shape[-1]):
            inputs.update((f"static.{k}", v) for k, v in args.items())
        kept = {} if keep is None else dict(zip(KEPT, (k[0] for k in keep)))
        key = graph_key({**inputs, **kept}, weights)
        step, first = self.graphs.pop(key, None), 0
        if step is None:
            bufs = self.buffers(inputs, t_tab[0], dt_tab[0], kept)
            with annotate("cfm.step"):
                step, first = self._capture(bufs, weights), 1
            while len(self.graphs) >= MAX_GRAPHS:
                self.graphs.popitem(last=False)
        else:
            for name, v in inputs.items():
                if v is not None:
                    step.bufs[name].copy_(v)
        self.graphs[key] = step
        for i in range(n_timesteps):
            if i >= first:
                with annotate("cfm.step"):
                    step.bufs["t"].copy_(t_tab[i])
                    step.bufs["dt"].copy_(dt_tab[i])
                    step.replay()
            for rows, name in zip(keep or (), KEPT):
                rows[i].copy_(step.bufs[name])
        launches.replayed(step.launches, n_timesteps - first)
        return step.bufs["x"].clone()

    def _schedule(self, n_timesteps: int, t_scheduler: str, dtype, device) -> tuple:
        """The device tables of t_i (in ``dtype``) and dt_i (f32), made once
        each: a host-to-device copy waits for the stream."""
        key = (n_timesteps, t_scheduler, dtype, device)
        if key not in self._tables:
            span = time_span(n_timesteps, t_scheduler)
            self._tables[key] = (span[:-1].to(dtype).to(device),
                                 (span[1:] - span[:-1]).to(device))
        return self._tables[key]

    def buffers(self, inputs: dict, t: torch.Tensor, dt: torch.Tensor,
                kept: Optional[dict] = None) -> dict:
        """Static buffers holding ``inputs`` and the first step's ``t`` and
        ``dt``, and one like each of ``kept`` (the kept rows, by name) that
        the step writes."""
        bufs = {k: None if v is None else v.clone() for k, v in inputs.items()}
        bufs.update((k, torch.empty_like(v)) for k, v in (kept or {}).items())
        bufs["t"], bufs["dt"] = t.clone(), dt.clone()
        return bufs

    def run(self, bufs: dict, weights: tuple) -> None:
        """One Euler step on the static buffers, the state updated in place;
        ``weights``: the CFG branches' (:func:`euler_step`)."""
        est = (bufs["prompt"], bufs["lens"], bufs["style"], bufs["mu"])
        static = {k[len("static."):]: v for k, v in bufs.items() if k.startswith("static.")}
        x = euler_step(self.estimate_fn, bufs["x"], bufs["t"], bufs["dt"], est,
                       (static,) if static else (), bufs["in_prompt"], weights,
                       StackShard(None, bufs["mu"].shape[0]),
                       keep=tuple(bufs[k] for k in KEPT) if KEPT[0] in bufs else None)
        bufs["x"].copy_(x)

    def _capture(self, bufs: dict, weights: tuple) -> StepGraph:
        """Run the first step on ``bufs`` eagerly on a side stream (it builds
        and caches what the step uses), then capture the step as a graph."""
        dev = bufs["mu"].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.run(bufs, weights)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with launches.captured() as launched, torch.cuda.graph(graph):
            self.run(bufs, weights)
        return StepGraph(bufs, graph.replay, launched)


def graph_key(inputs: dict, weights: tuple) -> tuple:
    """An :class:`EulerGraph` key: the CFG ``weights`` and each input's
    name, shape, dtype and device (None for an absent one)."""
    return (weights, *((k, None if v is None else (tuple(v.shape), v.dtype, v.device))
                       for k, v in inputs.items()))
