"""Composed v1 voice-conversion model: length regulator + CFM(DiT)
(inference half of ``seedvc_tpu/models/vc.py``; the training loss waits for
the training slice)."""

from __future__ import annotations

from torch import nn

from seedvc_tpu_torch.core.config import ModelParams
from seedvc_tpu_torch.models.cfm import CFM
from seedvc_tpu_torch.models.regulator import InterpolateRegulator


class VCModel(nn.Module):
    def __init__(self, mp: ModelParams):
        super().__init__()
        self.length_regulator = InterpolateRegulator(mp.length_regulator)
        self.cfm = CFM(mp)

    def regulate(self, features, ylens, target_len, f0=None, x_lens=None, f0_lens=None):
        return self.length_regulator(features, ylens, target_len, f0, x_lens=x_lens,
                                     f0_lens=f0_lens)[0]

    def estimate(self, x, prompt_x, x_lens, t, style, cond, static_cond=None):
        return self.cfm.estimate(x, prompt_x, x_lens, t, style, cond, static_cond=static_cond)

    def precompute_cond(self, x, prompt_x, x_lens, style, cond):
        return self.cfm.precompute_cond(x, prompt_x, x_lens, style, cond)
