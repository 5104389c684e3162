"""HF WhisperModel encoder state_dict -> ``models.whisper.WhisperEncoder`` params
(port of ``seedvc_tpu/convert/whisper.py``)."""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import _np, conv1d_kernel, linear_kernel


def convert_whisper_encoder(sd: dict, n_layers: int) -> dict:
    """sd: state_dict of the encoder (keys like 'conv1.weight' or
    'encoder.conv1.weight' — prefix stripped automatically)."""
    if any(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}

    def lin(prefix, bias=True):
        out = {"kernel": linear_kernel(sd[f"{prefix}.weight"])}
        if bias:
            out["bias"] = _np(sd[f"{prefix}.bias"])
        return out

    p: dict = {
        "conv1": {"kernel": conv1d_kernel(sd["conv1.weight"]),
                  "bias": _np(sd["conv1.bias"])},
        "conv2": {"kernel": conv1d_kernel(sd["conv2.weight"]),
                  "bias": _np(sd["conv2.bias"])},
        "embed_positions": _np(sd["embed_positions.weight"]),
        "layer_norm": {"scale": _np(sd["layer_norm.weight"]),
                       "bias": _np(sd["layer_norm.bias"])},
    }
    for i in range(n_layers):
        t = f"layers.{i}"
        p[f"layers_{i}"] = {
            "self_attn_layer_norm": {
                "scale": _np(sd[f"{t}.self_attn_layer_norm.weight"]),
                "bias": _np(sd[f"{t}.self_attn_layer_norm.bias"])},
            "self_attn": {
                "q_proj": lin(f"{t}.self_attn.q_proj"),
                "k_proj": lin(f"{t}.self_attn.k_proj", bias=False),
                "v_proj": lin(f"{t}.self_attn.v_proj"),
                "out_proj": lin(f"{t}.self_attn.out_proj"),
            },
            "final_layer_norm": {
                "scale": _np(sd[f"{t}.final_layer_norm.weight"]),
                "bias": _np(sd[f"{t}.final_layer_norm.bias"])},
            "fc1": lin(f"{t}.fc1"),
            "fc2": lin(f"{t}.fc2"),
        }
    return p
