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
The initial noise is an argument.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from vcbench.ref.core.config import ModelParams
from vcbench.ref.models.dit import DiT

SIGMA_MIN = 1e-6


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
                t_scheduler: str = "linear") -> torch.Tensor:
    """Euler CFG sampler; ``estimate_fn(x, prompt_x, x_lens, t, style, mu[,
    static_cond]) -> v``.

    noise: (B, T, n_mels) initial noise in mu's dtype (scaled by
    ``temperature``); mu: (B, T, D); x_lens: (B,) or None; prompt: (B, T,
    n_mels) zero past prompt_len. ``t_scheduler``: ``linear`` or ``cosine``
    (:func:`cosine_t_span`). ``precompute_fn(x, prompt_x, x_lens, style, mu)
    -> static_cond`` hoists the step-invariant conditioning out of the loop.
    Returns the generated mel (B, T, n_mels); the prompt region holds zeros.
    """
    if t_scheduler not in ("linear", "cosine"):
        raise ValueError(f"unknown t_scheduler {t_scheduler!r}")
    B, T, _ = mu.shape
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
    n = est_mu.shape[0]

    est_args = ()
    if precompute_fn is not None:
        x_shape = (n, T, noise.shape[-1])
        est_args = (precompute_fn(torch.zeros(x_shape, dtype=mu.dtype, device=mu.device),
                                  est_prompt, est_lens, est_style, est_mu),)

    for i in range(n_timesteps):
        t_cur = float(t_span[i])
        dt = float(t_span[i + 1] - t_span[i])
        xx = torch.cat([x, x], 0) if use_cfg else x
        tt = torch.full((n,), t_cur, dtype=mu.dtype, device=mu.device)
        v = estimate_fn(xx, est_prompt, est_lens, tt, est_style, est_mu, *est_args)
        if use_cfg:
            v_cond, v_null = v.chunk(2, dim=0)
            v = (1.0 + cfg_rate) * v_cond - cfg_rate * v_null
        x = (x.float() + dt * v.float()).to(x.dtype)
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x
