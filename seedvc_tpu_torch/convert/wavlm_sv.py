"""HF ``WavLMForXVector`` state_dict -> ``models.wavlm_sv.WavLMSV`` params (port
of ``seedvc_tpu/convert/wavlm_sv.py``).

The reference eval harness scores SECS with
``WavLMForXVector.from_pretrained("microsoft/wavlm-base-plus-sv")``
(``eval.py:293-303``); this converts that checkpoint for
``seedvc_tpu_torch/models/wavlm_sv.py``.
"""

from __future__ import annotations

import numpy as np

from seedvc_tpu_torch.convert.torch_utils import _np, conv1d_kernel, linear_kernel


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def convert_wavlm_sv(sd: dict, n_layers: int = 12,
                     n_conv: int = 7, n_tdnn: int = 5) -> dict:
    """Accepts the full WavLMForXVector state_dict."""
    p: dict = {}
    for i in range(n_conv):
        t = f"wavlm.feature_extractor.conv_layers.{i}"
        p[f"conv_layers_{i}"] = {"kernel": conv1d_kernel(sd[f"{t}.conv.weight"])}
        if f"{t}.conv.bias" in sd:
            p[f"conv_layers_{i}"]["bias"] = _np(sd[f"{t}.conv.bias"])
    # conv0's GroupNorm (group norm mode, modeling_wavlm.py:754-763)
    p["conv_group_norm"] = _ln(sd, "wavlm.feature_extractor.conv_layers.0.layer_norm")

    p["fp_layer_norm"] = _ln(sd, "wavlm.feature_projection.layer_norm")
    p["fp_projection"] = {
        "kernel": linear_kernel(sd["wavlm.feature_projection.projection.weight"]),
        "bias": _np(sd["wavlm.feature_projection.projection.bias"]),
    }

    key = "wavlm.encoder.pos_conv_embed.conv"
    if f"{key}.weight_g" in sd:
        g, v = _np(sd[f"{key}.weight_g"]), _np(sd[f"{key}.weight_v"])
        w = g * v / np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    elif f"{key}.parametrizations.weight.original0" in sd:
        g = _np(sd[f"{key}.parametrizations.weight.original0"])
        v = _np(sd[f"{key}.parametrizations.weight.original1"])
        w = g * v / np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    else:
        w = _np(sd[f"{key}.weight"])
    p["pos_conv"] = {"kernel": w.transpose(2, 1, 0),
                     "bias": _np(sd[f"{key}.bias"])}
    p["encoder_layer_norm"] = _ln(sd, "wavlm.encoder.layer_norm")

    # shared relative-position embedding lives on layer 0
    p["rel_attn_embed"] = _np(
        sd["wavlm.encoder.layers.0.attention.rel_attn_embed.weight"])

    for i in range(n_layers):
        t = f"wavlm.encoder.layers.{i}"
        attn = {
            "gru_rel_pos_const": _np(sd[f"{t}.attention.gru_rel_pos_const"]),
            "gru_rel_pos_linear": {
                "kernel": linear_kernel(sd[f"{t}.attention.gru_rel_pos_linear.weight"]),
                "bias": _np(sd[f"{t}.attention.gru_rel_pos_linear.bias"]),
            },
        }
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            attn[name] = {
                "kernel": linear_kernel(sd[f"{t}.attention.{name}.weight"]),
                "bias": _np(sd[f"{t}.attention.{name}.bias"]),
            }
        p[f"layers_{i}"] = {
            "attention": attn,
            "layer_norm": _ln(sd, f"{t}.layer_norm"),
            "final_layer_norm": _ln(sd, f"{t}.final_layer_norm"),
            "intermediate_dense": {
                "kernel": linear_kernel(sd[f"{t}.feed_forward.intermediate_dense.weight"]),
                "bias": _np(sd[f"{t}.feed_forward.intermediate_dense.bias"]),
            },
            "output_dense": {
                "kernel": linear_kernel(sd[f"{t}.feed_forward.output_dense.weight"]),
                "bias": _np(sd[f"{t}.feed_forward.output_dense.bias"]),
            },
        }

    p["layer_weights"] = _np(sd["layer_weights"])
    p["projector"] = {"kernel": linear_kernel(sd["projector.weight"]),
                      "bias": _np(sd["projector.bias"])}
    # TDNN "kernel" Linear(in*k -> out): weight (out, in*k) viewed as
    # (out, k, in) (modeling_wavlm.py:1540-1542) -> flax conv (k, in, out)
    for i in range(n_tdnn):
        w = _np(sd[f"tdnn.{i}.kernel.weight"])
        out_dim = w.shape[0]
        in_k = w.shape[1]
        # k from the config ordering 5/3/3/1/1 is implicit in in_k; recover
        # via the known input dim of this layer from the previous output
        prev = out_dim if i == 0 else _np(sd[f"tdnn.{i-1}.kernel.weight"]).shape[0]
        if i == 0:
            prev = _np(sd["projector.weight"]).shape[0]
        k = in_k // prev
        p[f"tdnn_{i}"] = {
            "kernel": w.reshape(out_dim, k, prev).transpose(1, 2, 0),
            "bias": _np(sd[f"tdnn.{i}.kernel.bias"]),
        }
    p["feature_extractor"] = {
        "kernel": linear_kernel(sd["feature_extractor.weight"]),
        "bias": _np(sd["feature_extractor.bias"]),
    }
    return p
