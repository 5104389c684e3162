"""Composed v1 voice-conversion model: length regulator + CFM(DiT)
(port of ``seedvc_tpu/models/vc.py``).

The training loss (:meth:`VCModel.forward`): regulate the original and the
timbre-perturbed content to mel rate, pick a prompt length per sample
(``int(frac·(mel_len−1))``, zero for the samples drawn so), splice the
original content into the prompt region, and take the CFM loss; with the VQ
bottleneck, its commitment and codebook losses are added with weights 0.05
and 0.15. Every random draw comes in one :class:`TrainDraws`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from vcbench.ref.core.config import ModelParams
from vcbench.ref.models.cfm import CFM
from vcbench.ref.models.regulator import InterpolateRegulator


class TrainDraws(NamedTuple):
    """The random draws of one training loss, all (B,)-leading:
    ``prompt_frac`` f32 in [0, 1), ``prompt_zero`` bool (that sample gets no
    prompt), ``t`` f32 in [0, 1), ``noise`` (B, T, n_mels) standard normal,
    ``cond_drop`` f32 1.0 = the null branch, or None when the preset's
    ``class_dropout_prob`` is 0."""

    prompt_frac: torch.Tensor
    prompt_zero: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor
    cond_drop: Optional[torch.Tensor] = None


def draw_train(generator: torch.Generator, B: int, T: int, n_mels: int,
               class_dropout_prob: float, device=None) -> TrainDraws:
    """One step's :class:`TrainDraws` from ``generator`` (on ``device``):
    the distributions of the JAX step's draws (10% of prompts zeroed, the
    dropout mask only when ``class_dropout_prob > 0``), not its bits."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    cond_drop = None
    prompt_frac, zero_u, t = rand(B), rand(B), rand(B)
    noise = torch.randn((B, T, n_mels), generator=generator, device=device)
    if class_dropout_prob > 0:
        cond_drop = (rand(B) < class_dropout_prob).to(torch.float32)
    return TrainDraws(prompt_frac, zero_u < 0.1, t, noise, cond_drop)


class VCModel(nn.Module):
    def __init__(self, mp: ModelParams):
        super().__init__()
        self.mp = mp
        self.length_regulator = InterpolateRegulator(mp.length_regulator)
        self.cfm = CFM(mp)

    def regulate(self, features, ylens, target_len, f0=None, x_lens=None, f0_lens=None):
        return self.length_regulator(features, ylens, target_len, f0, x_lens=x_lens,
                                     f0_lens=f0_lens)[0]

    def estimate(self, x, prompt_x, x_lens, t, style, cond, static_cond=None):
        return self.cfm.estimate(x, prompt_x, x_lens, t, style, cond, static_cond=static_cond)

    def precompute_cond(self, x, prompt_x, x_lens, style, cond):
        return self.cfm.precompute_cond(x, prompt_x, x_lens, style, cond)

    def forward(self, s_alt: torch.Tensor, s_ori: torch.Tensor, mels: torch.Tensor,
                mel_lens: torch.Tensor, style: torch.Tensor, draws: TrainDraws,
                f0: Optional[torch.Tensor] = None, s_lens: Optional[torch.Tensor] = None,
                f0_lens: Optional[torch.Tensor] = None):
        """Training loss. s_alt / s_ori: (B, T_s, D) perturbed / original
        content; mels: (B, T, C); mel_lens: (B,); style: (B, S); f0: (B, T_f0)
        Hz for F0 presets; s_lens / f0_lens: () true content / F0 lengths in
        their buffers. Returns (loss, CFM output)."""
        B, T, _ = mels.shape
        reg = self.length_regulator
        alt_cond, _, _, alt_commit, alt_cb = reg(s_alt, mel_lens, T, f0, x_lens=s_lens,
                                                 f0_lens=f0_lens)
        ori_cond, _, _, ori_commit, ori_cb = reg(s_ori, mel_lens, T, f0, x_lens=s_lens,
                                                 f0_lens=f0_lens)
        prompt_lens = (draws.prompt_frac * (mel_lens - 1).to(torch.float32)).to(torch.int32)
        prompt_lens = torch.where(draws.prompt_zero, torch.zeros_like(prompt_lens), prompt_lens)
        in_prompt = torch.arange(T, device=mels.device)[None, :, None] < prompt_lens[:, None, None]
        cond = torch.where(in_prompt, ori_cond, alt_cond)
        loss, out = self.cfm(mels, mel_lens, prompt_lens, cond, style, draws.t, draws.noise,
                             draws.cond_drop)
        if alt_commit is not None:
            loss = loss + (alt_commit + ori_commit) * 0.05 + (alt_cb + ori_cb) * 0.15
        return loss, out
