"""HiFT (CosyVoice hift.pt) torch checkpoint -> ``models.hifigan.HiFTGenerator``
parameter tree (port of ``seedvc_tpu/convert/hifigan.py``).

Reference layout: ``modules/hifigan/generator.py:284-390`` plus
``f0_predictor.py``.
"""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import (
    _np, conv1d_kernel, fold_weight_norm, linear_kernel)
from seedvc_tpu_torch.models.hifigan import HiFTConfig


def _wn_conv1d(sd, prefix):
    w = fold_weight_norm(sd, prefix)
    out = {"kernel": w.transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _resblock(sd, prefix, n_dil):
    blk = {}
    for i in range(n_dil):
        blk[f"convs1_{i}"] = _wn_conv1d(sd, f"{prefix}.convs1.{i}")
        blk[f"convs2_{i}"] = _wn_conv1d(sd, f"{prefix}.convs2.{i}")
        blk[f"act1_{i}"] = {"alpha": _np(sd[f"{prefix}.activations1.{i}.alpha"])}
        blk[f"act2_{i}"] = {"alpha": _np(sd[f"{prefix}.activations2.{i}.alpha"])}
    return blk


def convert_hift(sd: dict, cfg: HiFTConfig = HiFTConfig()) -> dict:
    if "generator" in sd:
        sd = sd["generator"]
    p: dict = {}

    # F0 predictor: condnet Sequential indices 0,2,4,6,8 are weight-normed convs.
    fp = {}
    for i in range(5):
        fp[f"condnet_{i}"] = _wn_conv1d(sd, f"f0_predictor.condnet.{2*i}")
    fp["classifier"] = {
        "kernel": linear_kernel(sd["f0_predictor.classifier.weight"]),
        "bias": _np(sd["f0_predictor.classifier.bias"]),
    }
    p["f0_predictor"] = fp

    p["m_source_linear"] = {
        "kernel": linear_kernel(sd["m_source.l_linear.weight"]),
        "bias": _np(sd["m_source.l_linear.bias"]),
    }
    p["conv_pre"] = _wn_conv1d(sd, "conv_pre")

    n_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        w = fold_weight_norm(sd, f"ups.{i}")  # ConvTranspose (in, out, K)
        p[f"ups_{i}_kernel"] = w.transpose(2, 0, 1)
        p[f"ups_{i}_bias"] = _np(sd[f"ups.{i}.bias"])
        # source_downs are plain convs (no weight norm).
        p[f"source_downs_{i}"] = {
            "kernel": conv1d_kernel(sd[f"source_downs.{i}.weight"]),
            "bias": _np(sd[f"source_downs.{i}.bias"]),
        }
        p[f"source_resblocks_{i}"] = _resblock(
            sd, f"source_resblocks.{i}",
            len(cfg.source_resblock_dilation_sizes[i]))
        for j in range(n_kernels):
            p[f"resblocks_{i}_{j}"] = _resblock(
                sd, f"resblocks.{i * n_kernels + j}",
                len(cfg.resblock_dilation_sizes[j]))

    p["conv_post"] = _wn_conv1d(sd, "conv_post")
    return p
