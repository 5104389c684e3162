"""Conditional flow matching: the OT-CFM training loss and the Euler ODE
sampler (port of ``seedvc_tpu/models/cfm.py``).

Training (:meth:`CFM.forward`): straight-path interpolant
``y = (1-(1-σ)t)·z + t·x1`` with target velocity ``u = x1 - (1-σ)·z``, the
prompt region of x1 spliced in as the prompt and zeroed in y, the loss taken
over [prompt_len, x_len) only and reduced in f32. The time ``t``, the noise
``z`` and the classifier-free dropout mask are arguments.

Inference: fixed-step Euler over a linear ``t_span = linspace(0, 1, n+1)``
(or v2's cosine schedule); classifier-free guidance stacks the conditional
batch with a null batch (zeroed prompt/style/mu) and combines
``(1+r)·cond − r·uncond``; the prompt region of x is re-zeroed every step.
The initial noise is an argument. ``shard_axis`` splits the CFG-stacked
batch over a mesh axis: each rank runs the estimator on its rows and the
ranks gather the velocity before the combination. ``seq_shard_axis`` splits
time over a mesh axis (:class:`~seedvc_tpu_torch.parallel.mesh.SeqShard`):
each rank runs the estimator on its time rows, the DiT's attention gathers
keys and values and its convolutions exchange halos, and the velocity is
gathered over time, then over the stack. Each Euler step is a
``cfm.step`` span of a ``torch.profiler`` trace and each estimator call in
it a ``dit.estimate`` span.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from seedvc_tpu_torch.core.config import ModelParams
from seedvc_tpu_torch.core.profiling import annotate
from seedvc_tpu_torch.models.dit import DiT
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
                  xx: torch.Tensor, t_cur: float, est: tuple, est_args: tuple) -> torch.Tensor:
    """One estimator call on this rank's stack rows and time rows of ``xx``
    (its time rows already taken; ``est`` = (prompt, lens, style, mu), this
    rank's rows), the velocity gathered over time, then over the stack."""
    n_local = xx.shape[0]
    prompt, lens, style, mu = est
    if n_local:
        tt = torch.full((n_local,), t_cur, dtype=mu.dtype, device=mu.device)
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
    if t_scheduler not in ("linear", "cosine"):
        raise ValueError(f"unknown t_scheduler {t_scheduler!r}")
    B, T, _ = mu.shape
    seq = time_shard(seq_shard_axis, T)
    t_span = (cosine_t_span(n_timesteps) if t_scheduler == "cosine"
              else torch.linspace(0.0, 1.0, n_timesteps + 1))
    noise = noise * temperature
    in_prompt = (torch.arange(T, device=mu.device) < prompt_len)[None, :, None]
    prompt_x = torch.where(in_prompt, prompt, torch.zeros_like(prompt))
    x = torch.where(in_prompt, torch.zeros_like(noise), noise)

    use_cfg = cfg_rate > 0
    if use_cfg:
        est_prompt = torch.cat([prompt_x, torch.zeros_like(prompt_x)], 0)
        est_style = torch.cat([style, torch.zeros_like(style)], 0)
        est_mu = torch.cat([mu, torch.zeros_like(mu)], 0)
        est_lens = None if x_lens is None else torch.cat([x_lens, x_lens], 0)
    else:
        est_prompt, est_style, est_mu, est_lens = prompt_x, style, mu, x_lens
    n_stack = est_mu.shape[0]
    shard = StackShard(shard_axis, n_stack)
    est_prompt, est_style, est_mu, est_lens = (shard.take(t) for t in (
        est_prompt, est_style, est_mu, est_lens))
    if seq is not None:
        est_prompt, est_mu = seq.take(est_prompt), seq.take(est_mu)
    n_local = est_mu.shape[0]

    est_args = ()
    if precompute_fn is not None and n_local:
        x_shape = (n_local, est_mu.shape[1], noise.shape[-1])
        with seq_shard_block(seq):
            est_args = (precompute_fn(torch.zeros(x_shape, dtype=mu.dtype, device=mu.device),
                                      est_prompt, est_lens, est_style, est_mu),)

    est = (est_prompt, est_lens, est_style, est_mu)
    for i in range(n_timesteps):
        # trace-only spans (no events), so a graph capture may run them
        with annotate("cfm.step"):
            t_cur = float(t_span[i])
            dt = float(t_span[i + 1] - t_span[i])
            xx = shard.take(torch.cat([x, x], 0) if use_cfg else x)
            if seq is not None:
                xx = seq.take(xx)
            with annotate("dit.estimate"):
                v = estimate_rows(estimate_fn, seq, shard, xx, t_cur, est, est_args)
            if use_cfg:
                v_cond, v_null = v.chunk(2, dim=0)
                v = (1.0 + cfg_rate) * v_cond - cfg_rate * v_null
            x = (x.float() + dt * v.float()).to(x.dtype)
            x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x
