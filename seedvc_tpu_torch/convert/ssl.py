"""HF Wav2Vec2Model / HubertModel state_dict -> ``models.ssl.SSLEncoder`` params
(port of ``seedvc_tpu/convert/ssl.py``)."""

from __future__ import annotations

import numpy as np

from seedvc_tpu_torch.convert.torch_utils import _np, conv1d_kernel, linear_kernel


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def convert_ssl(sd: dict, n_layers: int) -> dict:
    """Accepts the full Wav2Vec2Model/HubertModel state_dict."""
    p: dict = {}
    for i in range(7):
        t = f"feature_extractor.conv_layers.{i}"
        p[f"conv_layers_{i}"] = {
            "kernel": conv1d_kernel(sd[f"{t}.conv.weight"]),
            "bias": _np(sd[f"{t}.conv.bias"]),
        }
        p[f"conv_ln_{i}"] = _ln(sd, f"{t}.layer_norm")

    p["fp_layer_norm"] = _ln(sd, "feature_projection.layer_norm")
    p["fp_projection"] = {
        "kernel": linear_kernel(sd["feature_projection.projection.weight"]),
        "bias": _np(sd["feature_projection.projection.bias"]),
    }

    # pos conv: weight-normed grouped conv. torch weight (out, in/groups, K);
    # weight_norm here is over dim 2 (HF uses dim=2) — fold generically.
    key = "encoder.pos_conv_embed.conv"
    if f"{key}.weight_g" in sd:
        g = _np(sd[f"{key}.weight_g"])
        v = _np(sd[f"{key}.weight_v"])
        norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
        w = g * v / norm
    elif f"{key}.parametrizations.weight.original0" in sd:
        g = _np(sd[f"{key}.parametrizations.weight.original0"])
        v = _np(sd[f"{key}.parametrizations.weight.original1"])
        norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
        w = g * v / norm
    else:
        w = _np(sd[f"{key}.weight"])
    p["pos_conv"] = {"kernel": w.transpose(2, 1, 0),
                     "bias": _np(sd[f"{key}.bias"])}

    for i in range(n_layers):
        t = f"encoder.layers.{i}"
        p[f"layers_{i}"] = {
            "layer_norm": _ln(sd, f"{t}.layer_norm"),
            "q_proj": {"kernel": linear_kernel(sd[f"{t}.attention.q_proj.weight"]),
                       "bias": _np(sd[f"{t}.attention.q_proj.bias"])},
            "k_proj": {"kernel": linear_kernel(sd[f"{t}.attention.k_proj.weight"]),
                       "bias": _np(sd[f"{t}.attention.k_proj.bias"])},
            "v_proj": {"kernel": linear_kernel(sd[f"{t}.attention.v_proj.weight"]),
                       "bias": _np(sd[f"{t}.attention.v_proj.bias"])},
            "out_proj": {"kernel": linear_kernel(sd[f"{t}.attention.out_proj.weight"]),
                         "bias": _np(sd[f"{t}.attention.out_proj.bias"])},
            "final_layer_norm": _ln(sd, f"{t}.final_layer_norm"),
            "intermediate_dense": {
                "kernel": linear_kernel(sd[f"{t}.feed_forward.intermediate_dense.weight"]),
                "bias": _np(sd[f"{t}.feed_forward.intermediate_dense.bias"])},
            "output_dense": {
                "kernel": linear_kernel(sd[f"{t}.feed_forward.output_dense.weight"]),
                "bias": _np(sd[f"{t}.feed_forward.output_dense.bias"])},
        }
    if "encoder.layer_norm.weight" in sd:
        p["encoder_layer_norm"] = _ln(sd, "encoder.layer_norm")
    return p
