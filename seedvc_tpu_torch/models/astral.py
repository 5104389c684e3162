"""ASTRAL content quantizer (port of ``seedvc_tpu/models/astral.py``): SSL
features -> ConvNeXtV2 stage -> BSQ tokens. The HuBERT trunk
(``models/ssl.py::HUBERT_LARGE_L18``) runs once outside and feeds both
quantizers: "narrow" (codebook 32, the AR's source) and "wide" (codebook
2048, the CFM's condition)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from seedvc_tpu_torch.nn.bsq import BSQ
from seedvc_tpu_torch.nn.convnext import ConvNeXtV2Stage


@dataclass(frozen=True)
class AstralConfig:
    dim: int = 512
    intermediate_dim: int = 1536
    num_blocks: int = 12
    input_dim: int = 1024
    codebook_size: int = 2048


ASTRAL_NARROW = AstralConfig(codebook_size=32)
ASTRAL_WIDE = AstralConfig(codebook_size=2048)


class AstralQuantizer(nn.Module):
    def __init__(self, cfg: AstralConfig = ASTRAL_WIDE):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvNeXtV2Stage(dim=cfg.dim, intermediate_dim=cfg.intermediate_dim,
                                       num_blocks=cfg.num_blocks, input_dim=cfg.input_dim)
        self.quantizer = BSQ(cfg.dim, cfg.codebook_size)

    def forward(self, ssl_features: torch.Tensor, training: bool = False):
        """(B, T, input_dim) -> (quantized (B, T, dim), indices (B, T), aux_loss)."""
        return self.quantizer(self.encoder(ssl_features), training=training)

    def codes(self, ssl_features: torch.Tensor):
        """(indices (B, T), the normalised projection (B, T, bits) whose signs
        they are): the tokens without the quantized vector's projection."""
        h = self.quantizer.project(self.encoder(ssl_features))
        return self.quantizer.indices(h), h
