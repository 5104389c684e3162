"""v1 DiT/CFM + length-regulator torch checkpoints -> parameter trees (port
of ``seedvc_tpu/convert/dit.py``).

Converts the reference's trained checkpoints (``DiT_*.pth``, structure
``{'net': {'cfm': ..., 'length_regulator': ...}}`` per
``modules/commons.py:412-479``; DDP ``module.`` prefixes stripped, EMA key
variant supported) into the parameter trees of
``seedvc_tpu_torch.models.vc.VCModel``.

Layout notes:
- the reference gpt-fast fused wqkv row order [q ‖ k ‖ v] matches our Dense
  column order after transposition,
- weight-normed layers (x_embedder is unused by the forward pass; FinalLayer
  linear; WaveNet SConv1d convs) are folded,
- the reference's unused parameters (x_embedder, cond_embedder,
  content_mask_embedder, input_pos buffer, masks) are dropped.
"""

from __future__ import annotations

from seedvc_tpu_torch.core.config import ModelParams
from seedvc_tpu_torch.convert.torch_utils import _np, fold_weight_norm, linear_kernel


def strip_prefixes(sd: dict) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _lin(sd, prefix, bias=True):
    out = {"kernel": linear_kernel(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _wn_lin(sd, prefix):
    w = fold_weight_norm(sd, prefix)
    out = {"kernel": w.transpose(1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _conv1x1_as_dense(sd, prefix):
    w = _np(sd[f"{prefix}.weight"])  # (out, in, 1)
    out = {"kernel": w[:, :, 0].T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _adaln(sd, prefix):
    return {
        "norm": {"weight": _np(sd[f"{prefix}.norm.weight"])},
        "project_layer": _lin(sd, f"{prefix}.project_layer"),
    }


def _t_embedder(sd, prefix):
    return {"mlp0": _lin(sd, f"{prefix}.mlp.0"),
            "mlp2": _lin(sd, f"{prefix}.mlp.2")}


def _sconv1d(sd, prefix):
    """encodec SConv1d (prefix.conv.conv is a weight-normed Conv1d)."""
    w = fold_weight_norm(sd, f"{prefix}.conv.conv")  # (out, in, k)
    out = {"kernel": w.transpose(2, 1, 0)}
    if f"{prefix}.conv.conv.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.conv.conv.bias"])
    return out


def _sconv1d_as_dense(sd, prefix):
    w = fold_weight_norm(sd, f"{prefix}.conv.conv")  # (out, in, 1)
    out = {"kernel": w[:, :, 0].T}
    if f"{prefix}.conv.conv.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.conv.conv.bias"])
    return out


def convert_dit(sd: dict, mp: ModelParams) -> dict:
    """CFM state_dict (keys 'estimator.*') -> params for models.cfm.CFM."""
    sd = strip_prefixes(sd)
    sd = {k[len("estimator."):]: v for k, v in sd.items()
          if k.startswith("estimator.")}
    dc = mp.DiT
    est: dict = {
        "cond_projection": _lin(sd, "cond_projection"),
        "t_embedder": _t_embedder(sd, "t_embedder"),
        "cond_x_merge_linear": _lin(sd, "cond_x_merge_linear"),
    }
    if dc.long_skip_connection:
        est["skip_linear"] = _lin(sd, "skip_linear")
    if dc.style_as_token:
        est["style_in"] = _lin(sd, "style_in")

    trunk: dict = {"norm": _adaln(sd, "transformer.norm")}
    recv = ({i for i in range(dc.depth) if i > dc.depth // 2}
            if dc.uvit_skip_connection else set())
    for i in range(dc.depth):
        t = f"transformer.layers.{i}"
        layer = {
            "attention": {"wqkv": _lin(sd, f"{t}.attention.wqkv", bias=False),
                          "wo": _lin(sd, f"{t}.attention.wo", bias=False)},
            "feed_forward": {"w1": _lin(sd, f"{t}.feed_forward.w1", bias=False),
                             "w2": _lin(sd, f"{t}.feed_forward.w2", bias=False),
                             "w3": _lin(sd, f"{t}.feed_forward.w3", bias=False)},
            "attention_norm": _adaln(sd, f"{t}.attention_norm"),
            "ffn_norm": _adaln(sd, f"{t}.ffn_norm"),
        }
        if i in recv and f"{t}.skip_in_linear.weight" in sd:
            layer["skip_in_linear"] = _lin(sd, f"{t}.skip_in_linear")
        trunk[f"layers_{i}"] = layer
    est["transformer"] = trunk

    if dc.final_layer_type == "wavenet":
        wn_layers = mp.wavenet.num_layers
        wn = {"cond_layer": _sconv1d_as_dense(sd, "wavenet.cond_layer")}
        for i in range(wn_layers):
            wn[f"in_layers_{i}"] = _sconv1d(sd, f"wavenet.in_layers.{i}")
            # res_skip layers are nn.Conv(k=1) in our WaveNet -> (1, in, out)
            wn[f"res_skip_layers_{i}"] = _sconv1d(
                sd, f"wavenet.res_skip_layers.{i}")
        est.update({
            "conv1": _lin(sd, "conv1"),
            "t_embedder2": _t_embedder(sd, "t_embedder2"),
            "wavenet": wn,
            "res_projection": _lin(sd, "res_projection"),
            "final_layer": {
                "adaLN_modulation": _lin(sd, "final_layer.adaLN_modulation.1"),
                "linear": _wn_lin(sd, "final_layer.linear"),
            },
            "conv2": _conv1x1_as_dense(sd, "conv2"),
        })
    else:
        est["final_mlp0"] = _lin(sd, "final_mlp.0")
        est["final_mlp2"] = _lin(sd, "final_mlp.2")
    return {"estimator": est}


def convert_regulator(sd: dict, mp: ModelParams) -> dict:
    """length_regulator state_dict -> params for models.regulator."""
    sd = strip_prefixes(sd)
    lr = mp.length_regulator
    p: dict = {}
    if lr.is_discrete:
        p["embedding"] = {"embedding": _np(sd["embedding.weight"])}
        for i in range(1, lr.n_codebooks):
            p[f"extra_codebooks_{i-1}"] = {
                "embedding": _np(sd[f"extra_codebooks.{i-1}.weight"])}
    else:
        p["content_in_proj"] = _lin(sd, "content_in_proj")
    n = len(lr.sampling_ratios)
    for i in range(n):
        w = _np(sd[f"model.{3*i}.weight"])  # (out, in, 3)
        p[f"conv_{i}"] = {"kernel": w.transpose(2, 1, 0),
                          "bias": _np(sd[f"model.{3*i}.bias"])}
        p[f"norm_{i}"] = {"scale": _np(sd[f"model.{3*i+1}.weight"]),
                          "bias": _np(sd[f"model.{3*i+1}.bias"])}
    p["out_proj"] = _conv1x1_as_dense(sd, f"model.{3*n}")
    if lr.f0_condition:
        p["f0_embedding"] = {"embedding": _np(sd["f0_embedding.weight"])}
        p["f0_mask"] = _np(sd["f0_mask"]).reshape(1, -1)
    return p


def convert_vc_checkpoint(ckpt: dict, mp: ModelParams) -> dict:
    """Full reference checkpoint {'net': {'cfm', 'length_regulator'}} ->
    VCModel params {'cfm': ..., 'length_regulator': ...}."""
    net = ckpt.get("net", ckpt)
    return {
        "cfm": convert_dit(net["cfm"], mp),
        "length_regulator": convert_regulator(net["length_regulator"], mp),
    }
