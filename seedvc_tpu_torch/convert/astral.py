"""ASTRAL quantizer (ConvNeXtV2 encoder + BSQ) torch checkpoints -> params.

Covers the ``Plachta/ASTRAL-quantization`` bsq32/bsq2048 checkpoints
(``modules/astral_quantization/default_model.py:33-44``: state dict with
'net' containing 'encoder' and 'vq' sub-dicts, DDP prefixes possible).
"""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import _np, conv1d_kernel, linear_kernel


def convert_convnext_stage(sd: dict, num_blocks: int) -> dict:
    p: dict = {}
    if "input_projection.weight" in sd:
        p["input_projection"] = {
            "kernel": conv1d_kernel(sd["input_projection.weight"]),
            "bias": _np(sd["input_projection.bias"])}
    if "output_projection.weight" in sd:
        p["output_projection"] = {
            "kernel": conv1d_kernel(sd["output_projection.weight"]),
            "bias": _np(sd["output_projection.bias"])}
    for i in range(num_blocks):
        t = f"blocks.{i}"
        p[f"blocks_{i}"] = {
            "dwconv": {"kernel": conv1d_kernel(sd[f"{t}.dwconv.weight"]),
                       "bias": _np(sd[f"{t}.dwconv.bias"])},
            "norm": {"scale": _np(sd[f"{t}.norm.weight"]),
                     "bias": _np(sd[f"{t}.norm.bias"])},
            "pwconv1": {"kernel": linear_kernel(sd[f"{t}.pwconv1.weight"]),
                        "bias": _np(sd[f"{t}.pwconv1.bias"])},
            "pwconv2": {"kernel": linear_kernel(sd[f"{t}.pwconv2.weight"]),
                        "bias": _np(sd[f"{t}.pwconv2.bias"])},
            "grn": {"gamma": _np(sd[f"{t}.grn.gamma"]),
                    "beta": _np(sd[f"{t}.grn.beta"])},
        }
    return p


def convert_bsq(sd: dict) -> dict:
    p: dict = {}
    p["project_in"] = {"kernel": linear_kernel(sd["project_in.weight"])}
    if "project_in.bias" in sd:
        p["project_in"]["bias"] = _np(sd["project_in.bias"])
    p["project_out"] = {"kernel": linear_kernel(sd["project_out.weight"])}
    if "project_out.bias" in sd:
        p["project_out"]["bias"] = _np(sd["project_out.bias"])
    return p


def convert_astral(ckpt: dict, num_blocks: int = 12) -> dict:
    """Full ASTRAL checkpoint {'net': {'encoder', 'vq', ...}} -> params for
    models.astral.AstralQuantizer."""
    net = ckpt.get("net", ckpt)

    def strip(d):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in d.items()}

    return {
        "encoder": convert_convnext_stage(strip(net["encoder"]), num_blocks),
        "quantizer": convert_bsq(strip(net["vq"])),
    }
