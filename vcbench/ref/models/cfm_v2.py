"""v2's multi-condition CFG Euler sampler, plain: one device, the whole
stack in one estimator call, a Python loop.

The cosine t-schedule ``t <- t - (cos(pi t / 2) - 1 + t)``
(``models/cfm.py::cosine_t_span``); the stack holds up to three branches
[full / text-only / unconditional], combined with weights
``(1 + r0 + r1, -r1, -r0)`` for (r0, r1) = (intelligibility, similarity);
with either rate 0 it holds two, with both none, and ``random_voice``
(anonymisation) stacks [text-only / unconditional]. The Euler update runs in
f32 and is cast back; the prompt region is re-zeroed every step. The initial
noise is an argument.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from vcbench.ref.models.cfm import cosine_t_span


def cfg_branches(prompt_x, style, mu, cfg_rates: Sequence[float], random_voice: bool):
    """[(prompt, style, mu) per branch], weights."""
    r0, r1 = float(cfg_rates[0]), float(cfg_rates[1])
    zp, zs, zm = torch.zeros_like(prompt_x), torch.zeros_like(style), torch.zeros_like(mu)
    if random_voice:
        return [(zp, zs, mu), (zp, zs, zm)], (1.0 + r0, -r0)
    if r0 == 0 and r1 == 0:
        return [(prompt_x, style, mu)], (1.0,)
    if r0 == 0:
        return [(prompt_x, style, mu), (zp, zs, mu)], (1.0 + r1, -r1)
    if r1 == 0:
        return [(prompt_x, style, mu), (zp, zs, zm)], (1.0 + r0, -r0)
    return ([(prompt_x, style, mu), (zp, zs, mu), (zp, zs, zm)], (1.0 + r0 + r1, -r1, -r0))


def state_identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _combined(estimate_fn: Callable, mu: torch.Tensor, x_lens: Optional[torch.Tensor],
              prompt: torch.Tensor, prompt_len, style: torch.Tensor, cfg_rates: Sequence[float],
              random_voice: bool, precompute_fn: Optional[Callable]):
    """(the prompt region's mask, ``estimate(x, t)``: the stack's combined
    estimate at state x and time t)."""
    B, T, n_mels = prompt.shape
    in_prompt = (torch.arange(T, device=mu.device) < prompt_len)[None, :, None]
    prompt_x = torch.where(in_prompt, prompt, torch.zeros_like(prompt))
    branches, weights = cfg_branches(prompt_x, style, mu, cfg_rates, random_voice)
    n_br = len(branches)
    est_prompt, est_style, est_mu = (torch.cat([b[i] for b in branches], 0) for i in range(3))
    est_lens = None if x_lens is None else torch.cat([x_lens] * n_br, 0)
    w = torch.tensor(weights, dtype=mu.dtype, device=mu.device)
    est_args = ()
    if precompute_fn is not None:
        x_shape = (est_mu.shape[0], T, n_mels)
        est_args = (precompute_fn(torch.zeros(x_shape, dtype=mu.dtype, device=mu.device),
                                  est_prompt, est_lens, est_style, est_mu),)

    def estimate(x: torch.Tensor, t_cur: float) -> torch.Tensor:
        xx = torch.cat([x] * n_br, 0)
        t_vec = torch.full((xx.shape[0],), t_cur, device=x.device, dtype=mu.dtype)
        v = estimate_fn(xx, est_prompt, est_lens, t_vec, est_style, est_mu, *est_args)
        return torch.tensordot(w, v.reshape(n_br, B, *v.shape[1:]), dims=1)
    return in_prompt, estimate


@torch.no_grad()
def euler_solve_multicfg(estimate_fn: Callable, noise: torch.Tensor, mu: torch.Tensor,
                         x_lens: Optional[torch.Tensor], prompt: torch.Tensor, prompt_len,
                         style: torch.Tensor, n_timesteps: int = 10,
                         cfg_rates: Sequence[float] = (0.5, 0.5), random_voice: bool = False,
                         precompute_fn: Optional[Callable] = None,
                         round_state: Callable = state_identity) -> torch.Tensor:
    """``estimate_fn(x, prompt_x, x_lens, t, style, mu[, static_cond]) -> v``;
    noise (B, T, n_mels) in mu's dtype; returns the generated mel with the
    prompt region zeroed. ``round_state`` rounds the sampler's state (the
    noise and each update) where a lower precision holds it (the control)."""
    in_prompt, estimate = _combined(estimate_fn, mu, x_lens, prompt, prompt_len, style,
                                    cfg_rates, random_voice, precompute_fn)
    z = round_state(noise)
    x = torch.where(in_prompt, torch.zeros_like(z), z)
    t_span = cosine_t_span(n_timesteps)
    for i in range(n_timesteps):
        dt = float(t_span[i + 1] - t_span[i])
        v = estimate(x, float(t_span[i]))
        x = round_state((x.float() + dt * v.float()).to(x.dtype))
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x


@torch.no_grad()
def forced_estimates(estimate_fn: Callable, states, mu: torch.Tensor,
                     x_lens: Optional[torch.Tensor], prompt: torch.Tensor, prompt_len,
                     style: torch.Tensor, n_timesteps: int,
                     cfg_rates: Sequence[float] = (0.5, 0.5), random_voice: bool = False,
                     precompute_fn: Optional[Callable] = None) -> list[torch.Tensor]:
    """The combined estimate at each of ``states``, state i taken at step i
    of the ``n_timesteps``-step schedule: the sampler teacher-forced on
    another sampler's states, so that an estimate's error is its own and not
    the ODE's accumulation of every earlier one."""
    _, estimate = _combined(estimate_fn, mu, x_lens, prompt, prompt_len, style, cfg_rates,
                            random_voice, precompute_fn)
    t_span = cosine_t_span(n_timesteps)
    return [estimate(x.to(mu.dtype), float(t_span[i])) for i, x in enumerate(states)]
