"""v1 DiT estimator, the CFM vector-field network (port of
``seedvc_tpu/models/dit.py``), channels-last (B, T, C).

[x ‖ prompt_x ‖ projected cond ‖ repeated style] are merged by one linear
(``cond_x_merge_linear``); classifier-free dropout is a per-sample
``cond_drop`` mask zeroing every merged feature except x; a U-ViT trunk
conditioned on the time embedding; a long skip from the input; a WaveNet
post-net head with an adaLN final layer, or an MLP head.

With ``style_as_token`` the style leaves the merge and enters as a token
(``style_in``); with ``time_as_token`` the time embedding does, and the trunk
runs unconditioned. The prefix is ``[time, style, x...]``: keys are valid up
to ``x_lens`` plus the prefix, RoPE spans the prefix too, and the output drops
it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.core.config import ModelParams
from vcbench.ref.core.utils import sequence_mask
from vcbench.ref.nn.layers import Dense, TimestepEmbedder
from vcbench.ref.nn.transformer import Transformer, TransformerConfig
from vcbench.ref.nn.wavenet import WaveNet


class SplitDense(nn.Module):
    """A linear layer whose input is applied in slices of ONE (out, total_in)
    weight, so the step-invariant slice (prompt/cond/style) is computed once
    outside the sampler loop and the noisy-mel slice every step."""

    def __init__(self, total_in: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, total_in))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor, start: int, with_bias: bool) -> torch.Tensor:
        w = self.weight[:, start: start + x.shape[-1]].to(x.dtype)
        return F.linear(x, w, self.bias.to(x.dtype) if with_bias else None)


class FinalLayer(nn.Module):
    """LayerNorm (no affine, eps 1e-6) + adaLN shift/scale + linear."""

    def __init__(self, hidden_size: int, out_channels: int, cond_size: int):
        super().__init__()
        self.adaLN_modulation = nn.Linear(cond_size, 2 * hidden_size)
        self.norm_final = nn.LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False)
        self.linear = nn.Linear(hidden_size, out_channels)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(F.silu(c)).chunk(2, dim=-1)
        x = self.norm_final(x) * (1 + scale[:, None, :]) + shift[:, None, :]
        return self.linear(x)


class DiT(nn.Module):
    def __init__(self, mp: ModelParams):
        super().__init__()
        dc = mp.DiT
        # f0_condition only gates the regulator's F0 embedding: the DiT does
        # no F0 work of its own
        self.mp = mp
        C = dc.in_channels
        static_in = C + C + dc.hidden_dim
        if dc.style_condition and not dc.style_as_token:
            static_in += mp.style_encoder.dim
        self.cond_projection = Dense(dc.content_dim, dc.hidden_dim)
        self.cond_x_merge_linear = SplitDense(static_in, dc.hidden_dim)
        if dc.style_as_token:
            self.style_in = Dense(mp.style_encoder.dim, dc.hidden_dim)
        self.t_embedder = TimestepEmbedder(dc.hidden_dim)
        self.transformer = Transformer(TransformerConfig(
            dim=dc.hidden_dim, n_layer=dc.depth, n_head=dc.num_heads,
            head_dim=dc.hidden_dim // dc.num_heads, rope_base=dc.rope_base,
            norm_eps=dc.norm_eps, uvit_skip_connection=dc.uvit_skip_connection,
            time_as_token=dc.time_as_token, use_flash=dc.use_flash_attention))
        if dc.long_skip_connection:
            self.skip_linear = Dense(dc.hidden_dim + C, dc.hidden_dim)
        if dc.final_layer_type == "wavenet":
            wn = mp.wavenet
            self.conv1 = Dense(dc.hidden_dim, wn.hidden_dim)
            self.t_embedder2 = TimestepEmbedder(wn.hidden_dim)
            self.wavenet = WaveNet(wn.hidden_dim, wn.kernel_size, wn.dilation_rate,
                                   wn.num_layers, gin_channels=wn.hidden_dim)
            self.res_projection = Dense(dc.hidden_dim, wn.hidden_dim)
            self.final_layer = FinalLayer(wn.hidden_dim, wn.hidden_dim, dc.hidden_dim)
            self.conv2 = Dense(wn.hidden_dim, dc.in_channels)
        else:
            self.final_mlp0 = Dense(dc.hidden_dim, dc.hidden_dim)
            self.final_mlp2 = Dense(dc.hidden_dim, dc.in_channels)

    def forward(self, x, prompt_x, x_lens, t, style, cond, cond_drop=None,
                return_static: bool = False, static_cond: Optional[dict] = None):
        """x, prompt_x: (B, T, C_mel); x_lens: (B,) int or None (every frame
        valid); t: (B,); style: (B, S); cond: (B, T, content_dim);
        cond_drop: (B,) 1.0 = null branch.

        ``return_static=True`` returns only the step-invariant conditioning
        (``merged`` and, with ``style_as_token``, ``style_tok``) as a dict;
        passing it back as ``static_cond`` skips recomputing it."""
        dc = self.mp.DiT
        B, T, C = x.shape
        if static_cond is None:
            keep = 1.0 if cond_drop is None else (1.0 - cond_drop)[:, None, None].to(x.dtype)
            parts = [prompt_x * keep, self.cond_projection(cond.to(x.dtype)) * keep]
            if dc.style_condition and not dc.style_as_token:
                parts.append(style[:, None, :].expand(B, T, style.shape[-1]) * keep)
            merged_static = self.cond_x_merge_linear(torch.cat(parts, dim=-1), C, True)
            style_tok = None
            if dc.style_as_token:
                style_tok = (self.style_in(style.to(x.dtype))
                             * (1.0 if cond_drop is None else keep[:, 0]))
            if return_static:
                return {"merged": merged_static, "style_tok": style_tok}
        else:
            merged_static, style_tok = static_cond["merged"], static_cond["style_tok"]

        t1 = self.t_embedder(t)
        x_in = self.cond_x_merge_linear(x, 0, False) + merged_static
        prefix = []
        if dc.time_as_token:
            prefix.append(t1[:, None, :].to(x.dtype))
        if dc.style_as_token:
            prefix.append(style_tok[:, None, :])
        n_prefix = len(prefix)
        if prefix:
            x_in = torch.cat([*prefix, x_in], dim=1)
        lens = (None if x_lens is None
                else torch.clamp(x_lens + n_prefix, max=T + n_prefix).to(torch.int32))
        x_res = self.transformer(x_in, t1[:, None, :], lens)[:, n_prefix:]

        if dc.long_skip_connection:
            x_res = self.skip_linear(torch.cat([x_res.to(x.dtype), x], dim=-1))
        x_res = x_res.to(x.dtype)
        if dc.final_layer_type == "wavenet":
            h = self.conv1(x_res)
            t2 = self.t_embedder2(t)
            mask = None
            if x_lens is not None:
                mask = sequence_mask(x_lens, T)[..., None].to(x.dtype)
            h = self.wavenet(h, mask, g=t2[:, None, :].to(x.dtype))
            h = h + self.res_projection(x_res)
            h = self.final_layer(h, t1)
            return self.conv2(h.to(x.dtype))
        return self.final_mlp2(F.silu(self.final_mlp0(x_res)))
