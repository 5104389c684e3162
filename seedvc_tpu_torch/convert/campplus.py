"""CAMPPlus torch checkpoint -> parameter tree (port of
``seedvc_tpu/convert/campplus.py``).

Maps the 3D-Speaker/funasr ``campplus_cn_common.bin`` state_dict layout
(reference loads it at ``inference.py:93-101``) onto
``seedvc_tpu_torch.models.campplus.CAMPPlus``.
"""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import (
    _np, bn_params, conv1d_kernel, conv2d_kernel)


def convert_campplus(sd: dict) -> dict:
    """state_dict (possibly with legacy 'xvector.stats/dense' keys) -> params."""
    # Legacy key remap (reference DTDNN.py:113-130).
    sd = {k.replace("xvector.stats", "stats").replace("xvector.dense", "dense"): v
          for k, v in sd.items()}
    p: dict = {}

    def conv1(prefix):
        return {"kernel": conv1d_kernel(sd[f"{prefix}.weight"])}

    # --- FCM head ---
    head = {
        "conv1": {"kernel": conv2d_kernel(sd["head.conv1.weight"])},
        "bn1": bn_params(sd, "head.bn1"),
        "conv2": {"kernel": conv2d_kernel(sd["head.conv2.weight"])},
        "bn2": bn_params(sd, "head.bn2"),
    }
    for li in (1, 2):
        for bi in (0, 1):
            t = f"head.layer{li}.{bi}"
            blk = {
                "conv1": {"kernel": conv2d_kernel(sd[f"{t}.conv1.weight"])},
                "bn1": bn_params(sd, f"{t}.bn1"),
                "conv2": {"kernel": conv2d_kernel(sd[f"{t}.conv2.weight"])},
                "bn2": bn_params(sd, f"{t}.bn2"),
            }
            if f"{t}.shortcut.0.weight" in sd:
                blk["shortcut_conv"] = {"kernel": conv2d_kernel(sd[f"{t}.shortcut.0.weight"])}
                blk["shortcut_bn"] = bn_params(sd, f"{t}.shortcut.1")
            head[f"layer{li}_{bi}"] = blk
    p["head"] = head

    # --- TDNN stem ---
    p["tdnn_conv"] = conv1("xvector.tdnn.linear")
    p["tdnn_bn"] = bn_params(sd, "xvector.tdnn.nonlinear.batchnorm")

    # --- CAM-Dense-TDNN blocks ---
    for bi, num_layers in enumerate((12, 24, 16), start=1):
        for li in range(1, num_layers + 1):
            t = f"xvector.block{bi}.tdnnd{li}"
            p[f"block{bi}_tdnnd{li}"] = {
                "nonlinear1_bn": bn_params(sd, f"{t}.nonlinear1.batchnorm"),
                "linear1": conv1(f"{t}.linear1"),
                "nonlinear2_bn": bn_params(sd, f"{t}.nonlinear2.batchnorm"),
                "cam_layer": {
                    "linear_local": conv1(f"{t}.cam_layer.linear_local"),
                    "linear1": {
                        "kernel": conv1d_kernel(sd[f"{t}.cam_layer.linear1.weight"]),
                        "bias": _np(sd[f"{t}.cam_layer.linear1.bias"]),
                    },
                    "linear2": {
                        "kernel": conv1d_kernel(sd[f"{t}.cam_layer.linear2.weight"]),
                        "bias": _np(sd[f"{t}.cam_layer.linear2.bias"]),
                    },
                },
            }
        p[f"transit{bi}_bn"] = bn_params(sd, f"xvector.transit{bi}.nonlinear.batchnorm")
        p[f"transit{bi}_linear"] = conv1(f"xvector.transit{bi}.linear")

    p["out_nonlinear_bn"] = bn_params(sd, "xvector.out_nonlinear.batchnorm")
    p["dense_linear"] = {"kernel": _np(sd["dense.linear.weight"])[:, :, 0].T}
    p["dense_bn"] = bn_params(sd, "dense.nonlinear.batchnorm", affine=False)
    return p
