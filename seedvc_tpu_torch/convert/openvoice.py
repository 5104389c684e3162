"""OpenVoice converter checkpoint -> ToneColorConverter params (port of
``seedvc_tpu/convert/openvoice.py``).

Maps the myshell-ai/OpenVoiceV2 ``converter/checkpoint.pth`` ('model' state
dict of SynthesizerTrn with n_speakers=0) onto
``seedvc_tpu_torch.models.openvoice.ToneColorConverter``.
"""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import (
    _np, conv1d_kernel, conv2d_kernel, fold_weight_norm, linear_kernel)


def _conv1x1_dense(sd, prefix):
    w = _np(sd[f"{prefix}.weight"])
    out = {"kernel": w[:, :, 0].T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _wn_conv(sd, prefix):
    w = fold_weight_norm(sd, prefix)
    out = {"kernel": w.transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _vits_wn(sd, prefix, n_layers):
    """VITS WN (weight-normed plain convs) -> our WaveNet params."""
    p = {"cond_layer": {
        "kernel": fold_weight_norm(sd, f"{prefix}.cond_layer")[:, :, 0].T,
        "bias": _np(sd[f"{prefix}.cond_layer.bias"])}}
    for i in range(n_layers):
        p[f"in_layers_{i}"] = _wn_conv(sd, f"{prefix}.in_layers.{i}")
        p[f"res_skip_layers_{i}"] = _wn_conv(sd, f"{prefix}.res_skip_layers.{i}")
    return p


def convert_openvoice(sd: dict, n_flows: int = 4) -> dict:
    if "model" in sd:
        sd = sd["model"]
    p: dict = {}

    # reference encoder (convs are weight-normed 2-D convs)
    ref = {}
    for i in range(6):
        w = fold_weight_norm(sd, f"ref_enc.convs.{i}")  # (out, in, kh, kw)
        ref[f"convs_{i}"] = {"kernel": w.transpose(2, 3, 1, 0),
                             "bias": _np(sd[f"ref_enc.convs.{i}.bias"])}
    ref["gru"] = {
        "w_ih": _np(sd["ref_enc.gru.weight_ih_l0"]).T,
        "w_hh": _np(sd["ref_enc.gru.weight_hh_l0"]).T,
        "b_ih": _np(sd["ref_enc.gru.bias_ih_l0"]),
        "b_hh": _np(sd["ref_enc.gru.bias_hh_l0"]),
    }
    ref["proj"] = {"kernel": linear_kernel(sd["ref_enc.proj.weight"]),
                   "bias": _np(sd["ref_enc.proj.bias"])}
    p["ref_enc"] = ref

    # posterior encoder
    p["enc_q_pre"] = _conv1x1_dense(sd, "enc_q.pre")
    p["enc_q_wn"] = _vits_wn(sd, "enc_q.enc", 16)
    p["enc_q_proj"] = _conv1x1_dense(sd, "enc_q.proj")

    # flow (couplings at even indices 0,2,4,6 -> flows_{0..3})
    flow = {}
    for i in range(n_flows):
        t = f"flow.flows.{2*i}"
        flow[f"flows_{i}"] = {
            "pre": _conv1x1_dense(sd, f"{t}.pre"),
            "enc": _vits_wn(sd, f"{t}.enc", 4),
            "post": _conv1x1_dense(sd, f"{t}.post"),
        }
    p["flow"] = flow

    # decoder
    dec = {"conv_pre": {"kernel": conv1d_kernel(sd["dec.conv_pre.weight"]),
                        "bias": _np(sd["dec.conv_pre.bias"])},
           "cond": _conv1x1_dense(sd, "dec.cond"),
           "conv_post": {"kernel": conv1d_kernel(sd["dec.conv_post.weight"])}}
    n_up = len([k for k in sd if k.startswith("dec.ups.") and k.endswith(".bias")])
    n_res = len({int(k.split(".")[2]) for k in sd if k.startswith("dec.resblocks.")})
    n_kernels = n_res // n_up
    for i in range(n_up):
        w = fold_weight_norm(sd, f"dec.ups.{i}")  # ConvTranspose (in, out, K)
        dec[f"ups_{i}_kernel"] = w.transpose(2, 0, 1)
        dec[f"ups_{i}_bias"] = _np(sd[f"dec.ups.{i}.bias"])
        for j in range(n_kernels):
            idx = i * n_kernels + j
            blk = {}
            l = 0
            while f"dec.resblocks.{idx}.convs1.{l}.weight_g" in sd:
                blk[f"convs1_{l}"] = _wn_conv(sd, f"dec.resblocks.{idx}.convs1.{l}")
                blk[f"convs2_{l}"] = _wn_conv(sd, f"dec.resblocks.{idx}.convs2.{l}")
                l += 1
            dec[f"resblocks_{i}_{j}"] = blk
    p["dec"] = dec
    return p
