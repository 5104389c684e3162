"""Conditional flow matching: the Euler ODE sampler (port of the inference
half of ``seedvc_tpu/models/cfm.py``).

Fixed-step Euler over a linear ``t_span = linspace(0, 1, n+1)``;
classifier-free guidance stacks the conditional batch with a null batch
(zeroed prompt/style/mu) and combines ``(1+r)·cond − r·uncond``; the prompt
region of x is re-zeroed every step. The initial noise is an argument.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from seedvc_tpu_torch.core.config import ModelParams
from seedvc_tpu_torch.models.dit import DiT


class CFM(nn.Module):
    """Owns the DiT estimator; ``estimate`` is the raw vector field."""

    def __init__(self, mp: ModelParams):
        super().__init__()
        self.estimator = DiT(mp)

    def estimate(self, x, prompt_x, x_lens, t, style, cond, static_cond=None):
        return self.estimator(x, prompt_x, x_lens, t, style, cond, static_cond=static_cond)

    def precompute_cond(self, x, prompt_x, x_lens, style, cond):
        t0 = torch.zeros(x.shape[0], device=x.device)
        return self.estimator(x, prompt_x, x_lens, t0, style, cond, return_static=True)


@torch.no_grad()
def euler_solve(estimate_fn: Callable, noise: torch.Tensor, mu: torch.Tensor,
                x_lens: Optional[torch.Tensor], prompt: torch.Tensor, prompt_len: int,
                style: torch.Tensor, n_timesteps: int, cfg_rate: float = 0.7,
                precompute_fn: Optional[Callable] = None) -> torch.Tensor:
    """Euler CFG sampler; ``estimate_fn(x, prompt_x, x_lens, t, style, mu[,
    static_cond]) -> v``.

    noise: (B, T, n_mels) initial noise in mu's dtype; mu: (B, T, D);
    x_lens: (B,) or None; prompt: (B, T, n_mels) zero past prompt_len.
    ``precompute_fn(x, prompt_x, x_lens, style, mu) -> static_cond`` hoists
    the step-invariant conditioning out of the loop.
    Returns the generated mel (B, T, n_mels); the prompt region holds zeros.
    """
    B, T, _ = mu.shape
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1)
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

    est_args = ()
    if precompute_fn is not None:
        x_shape = (est_mu.shape[0], T, noise.shape[-1])
        est_args = (precompute_fn(torch.zeros(x_shape, dtype=mu.dtype, device=mu.device),
                                  est_prompt, est_lens, est_style, est_mu),)

    for i in range(n_timesteps):
        t_cur = float(t_span[i])
        dt = float(t_span[i + 1] - t_span[i])
        if use_cfg:
            tt = torch.full((2 * B,), t_cur, dtype=mu.dtype, device=mu.device)
            v = estimate_fn(torch.cat([x, x], 0), est_prompt, est_lens, tt, est_style,
                            est_mu, *est_args)
            v_cond, v_null = v.chunk(2, dim=0)
            v = (1.0 + cfg_rate) * v_cond - cfg_rate * v_null
        else:
            tt = torch.full((B,), t_cur, dtype=mu.dtype, device=mu.device)
            v = estimate_fn(x, est_prompt, est_lens, tt, est_style, est_mu, *est_args)
        x = (x.float() + dt * v.float()).to(x.dtype)
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x
