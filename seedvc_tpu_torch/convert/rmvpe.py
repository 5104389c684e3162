"""RMVPE (rmvpe.pt, E2E) torch checkpoint -> ``models.rmvpe.RMVPE_E2E`` parameter
tree (port of ``seedvc_tpu/convert/rmvpe.py``)."""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import _np, bn_params, conv2d_kernel, linear_kernel

N_BLOCKS = 4
EN_DE = 5
INTER = 4


def _convblockres(sd, prefix):
    out = {
        "conv0": {"kernel": conv2d_kernel(sd[f"{prefix}.conv.0.weight"])},
        "bn0": bn_params(sd, f"{prefix}.conv.1"),
        "conv1": {"kernel": conv2d_kernel(sd[f"{prefix}.conv.3.weight"])},
        "bn1": bn_params(sd, f"{prefix}.conv.4"),
    }
    if f"{prefix}.shortcut.weight" in sd:
        out["shortcut"] = {"kernel": conv2d_kernel(sd[f"{prefix}.shortcut.weight"]),
                           "bias": _np(sd[f"{prefix}.shortcut.bias"])}
    return out


def convert_rmvpe(sd: dict) -> dict:
    p: dict = {"encoder_bn": bn_params(sd, "unet.encoder.bn")}
    for i in range(EN_DE):
        for b in range(N_BLOCKS):
            p[f"enc_{i}_block_{b}"] = _convblockres(
                sd, f"unet.encoder.layers.{i}.conv.{b}")
    for j in range(INTER):
        for b in range(N_BLOCKS):
            p[f"inter_{j}_block_{b}"] = _convblockres(
                sd, f"unet.intermediate.layers.{j}.conv.{b}")
    for i in range(EN_DE):
        t = f"unet.decoder.layers.{i}"
        # ConvTranspose2d weight (in, out, kh, kw) -> (kh, kw, in, out)
        p[f"dec_{i}_up_kernel"] = _np(sd[f"{t}.conv1.0.weight"]).transpose(2, 3, 0, 1)
        p[f"dec_{i}_bn"] = bn_params(sd, f"{t}.conv1.1")
        for b in range(N_BLOCKS):
            p[f"dec_{i}_block_{b}"] = _convblockres(sd, f"{t}.conv2.{b}")

    p["cnn"] = {"kernel": conv2d_kernel(sd["cnn.weight"]),
                "bias": _np(sd["cnn.bias"])}
    p["gru_fwd"] = {
        "w_ih": _np(sd["fc.0.gru.weight_ih_l0"]).T,
        "w_hh": _np(sd["fc.0.gru.weight_hh_l0"]).T,
        "b_ih": _np(sd["fc.0.gru.bias_ih_l0"]),
        "b_hh": _np(sd["fc.0.gru.bias_hh_l0"]),
    }
    p["gru_bwd"] = {
        "w_ih": _np(sd["fc.0.gru.weight_ih_l0_reverse"]).T,
        "w_hh": _np(sd["fc.0.gru.weight_hh_l0_reverse"]).T,
        "b_ih": _np(sd["fc.0.gru.bias_ih_l0_reverse"]),
        "b_hh": _np(sd["fc.0.gru.bias_hh_l0_reverse"]),
    }
    p["fc_linear"] = {"kernel": linear_kernel(sd["fc.1.weight"]),
                      "bias": _np(sd["fc.1.bias"])}
    return p
