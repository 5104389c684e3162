"""v2 CFM: the cosine t-schedule, the multi-condition CFG Euler sampler and
the training loss (port of ``seedvc_tpu/models/cfm_v2.py``).

``t <- t - (cos(pi t / 2) - 1 + t)``; the CFG batch stacks up to three
branches [full / text-only / unconditional] and combines them with weights
``(1 + r0 + r1, -r1, -r0)``, where (r0, r1) = (intelligibility, similarity);
with either rate 0 the stack has two branches, with both none, and
``random_voice`` (anonymisation) stacks [text-only / unconditional]
(``models/cfm.py::cfg_branches``). The sampler is v1's Euler loop: the
update runs in f32 and is cast back; the prompt region is re-zeroed every
step. The initial noise is an argument.

:func:`cfm_v2_loss` is the OT-CFM loss with the prompt region given as the
condition, zeroed in the noisy input and left out of the loss; ``t`` and the
noise are arguments (the trainer draws them).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from seedvc_tpu_torch.models.cfm import _euler_loop, cfg_branches, cosine_t_span  # noqa: F401

SIGMA_MIN = 1e-6


@torch.no_grad()
def euler_solve_multicfg(estimate_fn: Callable, noise: torch.Tensor, mu: torch.Tensor,
                         x_lens: Optional[torch.Tensor], prompt: torch.Tensor, prompt_len,
                         style: torch.Tensor, n_timesteps: int = 10, temperature: float = 1.0,
                         cfg_rates: Sequence[float] = (0.5, 0.5), random_voice: bool = False,
                         precompute_fn: Optional[Callable] = None,
                         shard_axis: Optional[str] = None,
                         seq_shard_axis: Optional[str] = None,
                         keep: Optional[tuple] = None) -> torch.Tensor:
    """``estimate_fn(x, prompt_x, x_lens, t, style, mu[, static_cond]) -> v``.

    v1's sampler (``models/cfm.py``) over the cosine schedule and the CFG
    layout :func:`cfg_branches` gives ``cfg_rates`` and ``random_voice``.
    noise: (B, T, n_mels) initial noise in mu's dtype (scaled by
    ``temperature`` here); mu: (B, T, D); x_lens: (B,) or None; prompt:
    (B, T, n_mels); prompt_len: int. ``precompute_fn(x, prompt_x, x_lens,
    style, mu) -> static_cond`` hoists the step-invariant conditioning out of
    the loop. ``shard_axis``: split the stack over that axis of the
    ``set_mesh`` mesh (an uneven split too: 3 branches over 2 ranks are 2 and
    1 rows); every rank returns the whole result. ``seq_shard_axis``: split
    time over that axis, as the v1 sampler's. ``keep``: two buffers
    (n_timesteps, B, T, n_mels) whose row i step i fills with the state it
    estimated at and its combined estimate (two copies a step, into memory
    allocated once: holding each step's own tensors instead makes the
    allocator ask the device for more every step). Returns the generated
    mel; the prompt region holds zeros."""
    # this module's cfg_branches, looked up at each call, so a patch on it applies
    branches = functools.partial(cfg_branches, cfg_rates=cfg_rates, random_voice=random_voice)
    return _euler_loop(estimate_fn, noise, mu, x_lens, prompt, prompt_len, style, n_timesteps,
                       branches, precompute_fn, temperature, "cosine", shard_axis,
                       seq_shard_axis, keep)


def cfm_v2_loss(estimate_fn: Callable, x1: torch.Tensor, x_lens: torch.Tensor,
                prompt_lens: torch.Tensor, mu: torch.Tensor, style: torch.Tensor, *,
                t: torch.Tensor, noise: torch.Tensor, loss_type: str = "l1") -> torch.Tensor:
    """x1: (B, T, C) target mels; x_lens, prompt_lens: (B,); t: (B,) f32;
    noise: (B, T, C) in x1's dtype. ``y = (1 - (1 - sigma) t) z + t x1`` with
    the prompt frames zeroed, the target ``u = x1 - (1 - sigma) z``; the l1
    (or l2) error is averaged over each sample's ``valid x C`` elements
    (valid: past the prompt and below ``x_lens``), then over the batch."""
    if loss_type not in ("l1", "l2"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    B, T, C = x1.shape
    tb = t[:, None, None].to(x1.dtype)
    y = (1 - (1 - SIGMA_MIN) * tb) * noise + tb * x1
    u = x1 - (1 - SIGMA_MIN) * noise
    pos = torch.arange(T, device=x1.device)[None, :, None]
    in_prompt = pos < prompt_lens[:, None, None]
    zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
    prompt = torch.where(in_prompt, x1, zero)
    y = torch.where(in_prompt, zero, y)
    out = estimate_fn(y, prompt, x_lens, t, style, mu)
    valid = ((~in_prompt) & (pos < x_lens[:, None, None])).float()
    diff = (out - u).float()
    per = (diff * diff if loss_type == "l2" else diff.abs()) * valid
    denom = torch.clamp(valid.sum(dim=(1, 2)) * C, min=1.0)
    return (per.sum(dim=(1, 2)) / denom).mean()
