"""Writer of the reference's checkpoint layout, for tests and ``chip_smoke.py``.

Each ``write_*`` function is the inverse of a converter of
``seedvc_tpu_torch/convert`` (and of ``seedvc_tpu/convert``, its twin): it
turns a flax-layout parameter tree (numpy leaves, as
``seedvc_tpu_torch.weights.to_jax_params`` exports a port module) into the
torch state dict that the converter reads, with the reference's key names,
layouts and wrappers:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in); Conv ``kernel``
  (k, in, out) -> ``weight`` (out, in, k) and (kh, kw, in, out) -> (out, in,
  kh, kw); a transposed convolution's (K, in, out) -> (in, out, K);
- a weight-normed layer as ``weight_g`` = ||W|| (over every dim but 0, or
  over dims (0, 1) for the SSL positional conv) and ``weight_v`` = W, or as
  torch >= 2.1's ``parametrizations.weight.original0`` / ``original1``;
- BatchNorm as ``weight``, ``bias``, ``running_mean``, ``running_var`` and
  ``num_batches_tracked``;
- the file wrappers: ``{'net': {'cfm', 'length_regulator'}}`` (with an
  ``ema`` beside it), ``{'generator': ...}``, ``{'model': ...}``, DDP's
  ``module.`` prefix, HF's ``model.encoder.`` / ``wavlm.`` prefixes.

Keys a converter drops (the DiT's ``input_pos`` buffer, the SSL encoders'
``masked_spec_embed``, the x-vector head's ``objective``, the v2
regulators' ``mask_token``) are written too, so that the files look like
the published ones to the converters. :func:`save_safetensors` writes a
``.safetensors`` file without the ``safetensors`` package, and
:func:`zoo_contents` / :func:`write_zoo` the files of a model set under
``core/hub.py::MODEL_ZOO``'s file names.

This module imports torch and numpy only: ``chip_smoke.py`` imports it on a
machine without JAX.
"""

from __future__ import annotations

import json
import os
import re
import struct

import numpy as np
import torch

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def flat(tree: dict, prefix: str = "") -> dict:
    """A nested tree as {"a/b/leaf": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def halved(tree: dict) -> dict:
    """Every leaf times 0.5 (exact in binary): a second tree, such as an EMA,
    that differs from ``tree`` in every weight."""
    return {k: halved(v) if isinstance(v, dict) else 0.5 * v for k, v in tree.items()}


def _count(tree: dict, pattern: str) -> int:
    """How many keys of ``tree`` match ``pattern`` with ``{}`` as an index."""
    rx = re.compile("^" + pattern.replace("{}", r"(\d+)") + "$")
    return len([k for k in tree if rx.match(k)])


def _linear(sd: dict, prefix: str, p: dict):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: dict, prefix: str, p: dict):
    """Conv ``kernel`` (k..., in, out) -> ``weight`` (out, in, k...)."""
    k = np.asarray(p["kernel"])
    sd[f"{prefix}.weight"] = _t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1x1(sd: dict, prefix: str, p: dict):
    """A 1x1 Conv1d that the flax side holds as a Dense (in, out)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd: dict, prefix: str, p: dict):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: dict, prefix: str, p: dict):
    if "scale" in p:
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def weight_norm(sd: dict, prefix: str, w: np.ndarray, style: str = "weight_g",
                axes: tuple | None = None):
    """``w`` as a weight-normed layer's g = ||w|| and v = w; the norm over
    ``axes`` (default every dim but 0)."""
    w = np.ascontiguousarray(w, np.float32)  # summed in the layout the converter sums
    axes = tuple(range(1, w.ndim)) if axes is None else axes
    g = np.sqrt((w * w).sum(axis=axes, keepdims=True))
    if style == "weight_g":
        sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"] = _t(g), _t(w)
    elif style == "parametrizations":
        sd[f"{prefix}.parametrizations.weight.original0"] = _t(g)
        sd[f"{prefix}.parametrizations.weight.original1"] = _t(w)
    else:
        raise ValueError(f"unknown weight-norm style {style!r}")


def _wn_conv(sd: dict, prefix: str, p: dict, style: str = "weight_g"):
    k = np.asarray(p["kernel"])
    weight_norm(sd, prefix, k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)), style)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _wn_transposed(sd: dict, prefix: str, kernel, bias):
    """A weight-normed ConvTranspose1d: flax (K, in, out) -> torch (in, out, K)."""
    weight_norm(sd, prefix, np.asarray(kernel).transpose(1, 2, 0))
    sd[f"{prefix}.bias"] = _t(bias)


def _prefixed(sd: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# v1: DiT / CFM, regulator, CAMPPlus, BigVGAN, Whisper, RMVPE, HiFT
# ---------------------------------------------------------------------------
def _adaln(sd, prefix, p):
    """The reference's AdaptiveLayerNorm always owns a ``project_layer``; an
    unconditioned one (time as a token) holds it unused, written here as
    zeros."""
    w = np.asarray(p["norm"]["weight"])
    sd[f"{prefix}.norm.weight"] = _t(w)
    proj = p.get("project_layer", {"kernel": np.zeros((w.shape[0], 2 * w.shape[0]), w.dtype),
                                   "bias": np.zeros(2 * w.shape[0], w.dtype)})
    _linear(sd, f"{prefix}.project_layer", proj)


def _t_embedder(sd, prefix, p):
    _linear(sd, f"{prefix}.mlp.0", p["mlp0"])
    _linear(sd, f"{prefix}.mlp.2", p["mlp2"])


def _sconv1d(sd, prefix, p):
    """encodec SConv1d: ``prefix.conv.conv`` is a weight-normed Conv1d."""
    _wn_conv(sd, f"{prefix}.conv.conv", p)


def write_dit(cfm: dict, block_size: int = 64) -> dict:
    """``{'estimator': ...}`` (a CFM tree) -> the CFM state dict (``estimator.*``),
    with the unused ``input_pos`` buffer first, as the reference's module
    holds it."""
    est = cfm["estimator"]
    sd: dict = {"input_pos": torch.arange(block_size)}
    _linear(sd, "cond_projection", est["cond_projection"])
    _t_embedder(sd, "t_embedder", est["t_embedder"])
    _linear(sd, "cond_x_merge_linear", est["cond_x_merge_linear"])
    for name in ("skip_linear", "style_in"):
        if name in est:
            _linear(sd, name, est[name])
    trunk = est["transformer"]
    _adaln(sd, "transformer.norm", trunk["norm"])
    for i in range(_count(trunk, "layers_{}")):
        t, layer = f"transformer.layers.{i}", trunk[f"layers_{i}"]
        for name in ("wqkv", "wo"):
            _linear(sd, f"{t}.attention.{name}", layer["attention"][name])
        for name in ("w1", "w2", "w3"):
            _linear(sd, f"{t}.feed_forward.{name}", layer["feed_forward"][name])
        _adaln(sd, f"{t}.attention_norm", layer["attention_norm"])
        _adaln(sd, f"{t}.ffn_norm", layer["ffn_norm"])
        if "skip_in_linear" in layer:
            _linear(sd, f"{t}.skip_in_linear", layer["skip_in_linear"])
    if "wavenet" in est:
        wn = est["wavenet"]
        _linear(sd, "conv1", est["conv1"])
        _t_embedder(sd, "t_embedder2", est["t_embedder2"])
        cond = wn["cond_layer"]
        weight_norm(sd, "wavenet.cond_layer.conv.conv", np.asarray(cond["kernel"]).T[:, :, None])
        sd["wavenet.cond_layer.conv.conv.bias"] = _t(cond["bias"])
        for i in range(_count(wn, "in_layers_{}")):
            _sconv1d(sd, f"wavenet.in_layers.{i}", wn[f"in_layers_{i}"])
            _sconv1d(sd, f"wavenet.res_skip_layers.{i}", wn[f"res_skip_layers_{i}"])
        _linear(sd, "res_projection", est["res_projection"])
        fl = est["final_layer"]
        _linear(sd, "final_layer.adaLN_modulation.1", fl["adaLN_modulation"])
        weight_norm(sd, "final_layer.linear", np.asarray(fl["linear"]["kernel"]).T)
        sd["final_layer.linear.bias"] = _t(fl["linear"]["bias"])
        _conv1x1(sd, "conv2", est["conv2"])
    else:
        _linear(sd, "final_mlp.0", est["final_mlp0"])
        _linear(sd, "final_mlp.2", est["final_mlp2"])
    return _prefixed(sd, "estimator.")


def _regulator_body(sd: dict, p: dict):
    n = _count(p, "conv_{}")
    for i in range(n):
        _conv(sd, f"model.{3 * i}", p[f"conv_{i}"])
        _norm(sd, f"model.{3 * i + 1}", p[f"norm_{i}"])
    return n


def write_regulator(p: dict) -> dict:
    """A v1 ``InterpolateRegulator`` tree -> its state dict."""
    sd: dict = {}
    if "embedding" in p:
        sd["embedding.weight"] = _t(p["embedding"]["embedding"])
        for i in range(_count(p, "extra_codebooks_{}")):
            sd[f"extra_codebooks.{i}.weight"] = _t(p[f"extra_codebooks_{i}"]["embedding"])
    else:
        _linear(sd, "content_in_proj", p["content_in_proj"])
    n = _regulator_body(sd, p)
    _conv1x1(sd, f"model.{3 * n}", p["out_proj"])
    if "f0_embedding" in p:
        sd["f0_embedding.weight"] = _t(p["f0_embedding"]["embedding"])
        sd["f0_mask"] = _t(p["f0_mask"])
    return sd


def ema_of(net: dict) -> dict:
    """The EMA entry of a ``{'net': ...}`` checkpoint: for each key, the
    state dict's tensors in order without the ``input_pos`` buffers, as a
    positional list (the reference's ``modules/commons.py`` layout)."""
    return {key: [[v for k, v in sd.items() if "input_pos" not in k]]
            for key, sd in net.items()}


def write_vc_checkpoint(vc: dict, ema_vc: dict | None = None, *, ddp: bool = False,
                        block_size: int = 64) -> dict:
    """A ``VCModel`` tree (``{'cfm', 'length_regulator'}``) -> the reference's
    ``DiT_*.pth`` content ``{'net': {'cfm', 'length_regulator'}}``; with
    ``ema_vc`` an ``ema`` entry from that tree; with ``ddp`` every key gets
    DDP's ``module.`` prefix."""
    def net_of(tree):
        net = {"cfm": write_dit(tree["cfm"], block_size),
               "length_regulator": write_regulator(tree["length_regulator"])}
        return {k: _prefixed(v, "module.") for k, v in net.items()} if ddp else net

    ckpt = {"net": net_of(vc)}
    if ema_vc is not None:
        ckpt["ema"] = ema_of(net_of(ema_vc))
    return ckpt


def write_campplus(p: dict, legacy: bool = False) -> dict:
    """A CAMPPlus tree -> the ``campplus_cn_common.bin`` state dict; with
    ``legacy`` the x-vector head under ``xvector.dense`` as the old DTDNN."""
    sd: dict = {}
    head = p["head"]
    for name in ("conv1", "conv2"):
        _conv(sd, f"head.{name}", head[name])
    _bn(sd, "head.bn1", head["bn1"])
    _bn(sd, "head.bn2", head["bn2"])
    for li in (1, 2):
        for bi in (0, 1):
            t, blk = f"head.layer{li}.{bi}", head[f"layer{li}_{bi}"]
            _conv(sd, f"{t}.conv1", blk["conv1"])
            _bn(sd, f"{t}.bn1", blk["bn1"])
            _conv(sd, f"{t}.conv2", blk["conv2"])
            _bn(sd, f"{t}.bn2", blk["bn2"])
            if "shortcut_conv" in blk:
                _conv(sd, f"{t}.shortcut.0", blk["shortcut_conv"])
                _bn(sd, f"{t}.shortcut.1", blk["shortcut_bn"])
    _conv(sd, "xvector.tdnn.linear", p["tdnn_conv"])
    _bn(sd, "xvector.tdnn.nonlinear.batchnorm", p["tdnn_bn"])
    for bi, num_layers in enumerate((12, 24, 16), start=1):
        for li in range(1, num_layers + 1):
            t, blk = f"xvector.block{bi}.tdnnd{li}", p[f"block{bi}_tdnnd{li}"]
            _bn(sd, f"{t}.nonlinear1.batchnorm", blk["nonlinear1_bn"])
            _conv(sd, f"{t}.linear1", blk["linear1"])
            _bn(sd, f"{t}.nonlinear2.batchnorm", blk["nonlinear2_bn"])
            cam = blk["cam_layer"]
            for name in ("linear_local", "linear1", "linear2"):
                _conv(sd, f"{t}.cam_layer.{name}", cam[name])
        _bn(sd, f"xvector.transit{bi}.nonlinear.batchnorm", p[f"transit{bi}_bn"])
        _conv(sd, f"xvector.transit{bi}.linear", p[f"transit{bi}_linear"])
    _bn(sd, "xvector.out_nonlinear.batchnorm", p["out_nonlinear_bn"])
    dense = "xvector.dense" if legacy else "dense"
    _conv1x1(sd, f"{dense}.linear", p["dense_linear"])
    _bn(sd, f"{dense}.nonlinear.batchnorm", p["dense_bn"])
    return sd


def _amp_acts(sd, prefix, blk, l):
    for name, k in (("act1", 2 * l), ("act2", 2 * l + 1)):
        act = blk[f"{name}_{l}"]
        sd[f"{prefix}.activations.{k}.act.alpha"] = _t(act["alpha"])
        if "beta" in act:
            sd[f"{prefix}.activations.{k}.act.beta"] = _t(act["beta"])


def write_bigvgan(p: dict) -> dict:
    """A BigVGAN tree -> ``bigvgan_generator.pt``'s ``{'generator': ...}``."""
    sd: dict = {}
    _wn_conv(sd, "conv_pre", p["conv_pre"])
    n_up = _count(p, "ups_{}_kernel")
    n_kernels = _count(p, "resblocks_0_{}")
    for i in range(n_up):
        _wn_transposed(sd, f"ups.{i}.0", p[f"ups_{i}_kernel"], p[f"ups_{i}_bias"])
        for j in range(n_kernels):
            idx, blk = i * n_kernels + j, p[f"resblocks_{i}_{j}"]
            for l in range(_count(blk, "convs1_{}")):
                _wn_conv(sd, f"resblocks.{idx}.convs1.{l}", blk[f"convs1_{l}"])
                _wn_conv(sd, f"resblocks.{idx}.convs2.{l}", blk[f"convs2_{l}"])
                _amp_acts(sd, f"resblocks.{idx}", blk, l)
    sd["activation_post.act.alpha"] = _t(p["activation_post"]["alpha"])
    if "beta" in p["activation_post"]:
        sd["activation_post.act.beta"] = _t(p["activation_post"]["beta"])
    _wn_conv(sd, "conv_post", p["conv_post"])
    return {"generator": sd}


def write_whisper(p: dict, prefix: str = "model.encoder.") -> dict:
    """A Whisper encoder tree -> its HF state dict (``model.encoder.*`` as in
    ``WhisperForConditionalGeneration``'s ``model.safetensors``)."""
    sd: dict = {}
    _conv(sd, "conv1", p["conv1"])
    _conv(sd, "conv2", p["conv2"])
    sd["embed_positions.weight"] = _t(p["embed_positions"])
    for i in range(_count(p, "layers_{}")):
        t, layer = f"layers.{i}", p[f"layers_{i}"]
        _norm(sd, f"{t}.self_attn_layer_norm", layer["self_attn_layer_norm"])
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(sd, f"{t}.self_attn.{name}", layer["self_attn"][name])
        _norm(sd, f"{t}.final_layer_norm", layer["final_layer_norm"])
        _linear(sd, f"{t}.fc1", layer["fc1"])
        _linear(sd, f"{t}.fc2", layer["fc2"])
    _norm(sd, "layer_norm", p["layer_norm"])
    return _prefixed(sd, prefix)


def _convblockres(sd, prefix, p):
    _conv(sd, f"{prefix}.conv.0", p["conv0"])
    _bn(sd, f"{prefix}.conv.1", p["bn0"])
    _conv(sd, f"{prefix}.conv.3", p["conv1"])
    _bn(sd, f"{prefix}.conv.4", p["bn1"])
    if "shortcut" in p:
        _conv(sd, f"{prefix}.shortcut", p["shortcut"])


def _gru(sd, prefix, p, suffix=""):
    for flax, torch_name in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
        sd[f"{prefix}.{torch_name}{suffix}"] = _t(np.asarray(p[flax]).T)
    for flax, torch_name in (("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        sd[f"{prefix}.{torch_name}{suffix}"] = _t(p[flax])


def write_rmvpe(p: dict) -> dict:
    """An ``RMVPE_E2E`` tree (the full 4 x 5 x 4 U-Net) -> ``rmvpe.pt``'s state dict."""
    sd: dict = {}
    _bn(sd, "unet.encoder.bn", p["encoder_bn"])
    for i in range(_count(p, "enc_{}_block_0")):
        for b in range(_count(p, f"enc_{i}_block_{{}}")):
            _convblockres(sd, f"unet.encoder.layers.{i}.conv.{b}", p[f"enc_{i}_block_{b}"])
    for j in range(_count(p, "inter_{}_block_0")):
        for b in range(_count(p, f"inter_{j}_block_{{}}")):
            _convblockres(sd, f"unet.intermediate.layers.{j}.conv.{b}",
                          p[f"inter_{j}_block_{b}"])
    for i in range(_count(p, "dec_{}_up_kernel")):
        t = f"unet.decoder.layers.{i}"
        # ConvTranspose2d: (kh, kw, in, out) -> (in, out, kh, kw)
        sd[f"{t}.conv1.0.weight"] = _t(np.asarray(p[f"dec_{i}_up_kernel"]).transpose(2, 3, 0, 1))
        _bn(sd, f"{t}.conv1.1", p[f"dec_{i}_bn"])
        for b in range(_count(p, f"dec_{i}_block_{{}}")):
            _convblockres(sd, f"{t}.conv2.{b}", p[f"dec_{i}_block_{b}"])
    _conv(sd, "cnn", p["cnn"])
    _gru(sd, "fc.0.gru", p["gru_fwd"])
    _gru(sd, "fc.0.gru", p["gru_bwd"], "_reverse")
    _linear(sd, "fc.1", p["fc_linear"])
    return sd


def _hift_resblock(sd, prefix, blk):
    for i in range(_count(blk, "convs1_{}")):
        _wn_conv(sd, f"{prefix}.convs1.{i}", blk[f"convs1_{i}"])
        _wn_conv(sd, f"{prefix}.convs2.{i}", blk[f"convs2_{i}"])
        sd[f"{prefix}.activations1.{i}.alpha"] = _t(blk[f"act1_{i}"]["alpha"])
        sd[f"{prefix}.activations2.{i}.alpha"] = _t(blk[f"act2_{i}"]["alpha"])


def write_hift(p: dict) -> dict:
    """A ``HiFTGenerator`` tree -> ``hift.pt``'s state dict."""
    sd: dict = {}
    fp = p["f0_predictor"]
    for i in range(_count(fp, "condnet_{}")):
        _wn_conv(sd, f"f0_predictor.condnet.{2 * i}", fp[f"condnet_{i}"])
    _linear(sd, "f0_predictor.classifier", fp["classifier"])
    _linear(sd, "m_source.l_linear", p["m_source_linear"])
    _wn_conv(sd, "conv_pre", p["conv_pre"])
    n_kernels = _count(p, "resblocks_0_{}")
    for i in range(_count(p, "ups_{}_kernel")):
        _wn_transposed(sd, f"ups.{i}", p[f"ups_{i}_kernel"], p[f"ups_{i}_bias"])
        _conv(sd, f"source_downs.{i}", p[f"source_downs_{i}"])
        _hift_resblock(sd, f"source_resblocks.{i}", p[f"source_resblocks_{i}"])
        for j in range(n_kernels):
            _hift_resblock(sd, f"resblocks.{i * n_kernels + j}", p[f"resblocks_{i}_{j}"])
    _wn_conv(sd, "conv_post", p["conv_post"])
    return sd


# ---------------------------------------------------------------------------
# SSL encoders (HF Wav2Vec2Model / HubertModel) and WavLMForXVector
# ---------------------------------------------------------------------------
def _pos_conv(sd, key, p, style):
    """HF's weight-normed positional conv, normed over dims (0, 1)."""
    if style is None:
        _conv(sd, key, p)
        return
    k = np.asarray(p["kernel"])
    weight_norm(sd, key, k.transpose(2, 1, 0), style, axes=(0, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _ffn(sd, t, layer):
    _linear(sd, f"{t}.feed_forward.intermediate_dense", layer["intermediate_dense"])
    _linear(sd, f"{t}.feed_forward.output_dense", layer["output_dense"])


def write_ssl(p: dict, style: str | None = "parametrizations", seed: int = 0) -> dict:
    """An ``SSLEncoder`` tree -> an HF ``Wav2Vec2Model`` / ``HubertModel``
    state dict ("layer" feature-extractor norm, stable layer norm);
    ``style`` is the positional conv's weight norm (None: a plain weight)."""
    sd: dict = {}
    d_model = np.asarray(p["fp_projection"]["bias"]).shape[0]
    sd["masked_spec_embed"] = _t(np.random.default_rng(seed).uniform(size=d_model)
                                 .astype(np.float32))
    for i in range(_count(p, "conv_layers_{}")):
        t = f"feature_extractor.conv_layers.{i}"
        _conv(sd, f"{t}.conv", p[f"conv_layers_{i}"])
        _norm(sd, f"{t}.layer_norm", p[f"conv_ln_{i}"])
    _norm(sd, "feature_projection.layer_norm", p["fp_layer_norm"])
    _linear(sd, "feature_projection.projection", p["fp_projection"])
    _pos_conv(sd, "encoder.pos_conv_embed.conv", p["pos_conv"], style)
    if "encoder_layer_norm" in p:
        _norm(sd, "encoder.layer_norm", p["encoder_layer_norm"])
    for i in range(_count(p, "layers_{}")):
        t, layer = f"encoder.layers.{i}", p[f"layers_{i}"]
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(sd, f"{t}.attention.{name}", layer[name])
        _norm(sd, f"{t}.layer_norm", layer["layer_norm"])
        _ffn(sd, t, layer)
        _norm(sd, f"{t}.final_layer_norm", layer["final_layer_norm"])
    return sd


def write_wavlm_sv(p: dict, style: str | None = "parametrizations", num_labels: int = 2,
                   seed: int = 0) -> dict:
    """A ``WavLMSV`` tree -> an HF ``WavLMForXVector`` state dict ("group"
    feature-extractor norm); the AM-softmax ``objective`` of ``num_labels``
    speakers, which the converter drops, is written too."""
    rng = np.random.default_rng(seed)
    sd: dict = {}
    d_model = np.asarray(p["fp_projection"]["bias"]).shape[0]
    sd["wavlm.masked_spec_embed"] = _t(rng.uniform(size=d_model).astype(np.float32))
    for i in range(_count(p, "conv_layers_{}")):
        _conv(sd, f"wavlm.feature_extractor.conv_layers.{i}.conv", p[f"conv_layers_{i}"])
        if i == 0:
            _norm(sd, "wavlm.feature_extractor.conv_layers.0.layer_norm", p["conv_group_norm"])
    _norm(sd, "wavlm.feature_projection.layer_norm", p["fp_layer_norm"])
    _linear(sd, "wavlm.feature_projection.projection", p["fp_projection"])
    _pos_conv(sd, "wavlm.encoder.pos_conv_embed.conv", p["pos_conv"], style)
    _norm(sd, "wavlm.encoder.layer_norm", p["encoder_layer_norm"])
    for i in range(_count(p, "layers_{}")):
        t, layer = f"wavlm.encoder.layers.{i}", p[f"layers_{i}"]
        attn = layer["attention"]
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(sd, f"{t}.attention.{name}", attn[name])
        sd[f"{t}.attention.gru_rel_pos_const"] = _t(attn["gru_rel_pos_const"])
        _linear(sd, f"{t}.attention.gru_rel_pos_linear", attn["gru_rel_pos_linear"])
        if i == 0:
            sd[f"{t}.attention.rel_attn_embed.weight"] = _t(p["rel_attn_embed"])
        _norm(sd, f"{t}.layer_norm", layer["layer_norm"])
        _ffn(sd, t, layer)
        _norm(sd, f"{t}.final_layer_norm", layer["final_layer_norm"])
    sd["layer_weights"] = _t(p["layer_weights"])
    _linear(sd, "projector", p["projector"])
    for i in range(_count(p, "tdnn_{}")):
        k = np.asarray(p[f"tdnn_{i}"]["kernel"])  # (k, in, out) -> (out, k * in)
        sd[f"tdnn.{i}.kernel.weight"] = _t(k.transpose(2, 0, 1).reshape(k.shape[2], -1))
        sd[f"tdnn.{i}.kernel.bias"] = _t(p[f"tdnn_{i}"]["bias"])
    _linear(sd, "feature_extractor", p["feature_extractor"])
    x_dim = np.asarray(p["feature_extractor"]["bias"]).shape[0]
    sd["classifier.weight"] = _t(rng.standard_normal((x_dim, x_dim)).astype(np.float32))
    sd["classifier.bias"] = _t(np.zeros(x_dim, np.float32))
    sd["objective.weight"] = _t(rng.standard_normal((x_dim, num_labels)).astype(np.float32))
    return sd


# ---------------------------------------------------------------------------
# v2: ASTRAL, DiT v2, v2 regulators, AR; OpenVoice
# ---------------------------------------------------------------------------
def write_astral(p: dict) -> dict:
    """An ``AstralQuantizer`` tree -> ``{'net': {'encoder', 'vq'}}``."""
    enc, q = p["encoder"], p["quantizer"]
    e: dict = {}
    for name in ("input_projection", "output_projection"):
        if name in enc:
            _conv(e, name, enc[name])
    for i in range(_count(enc, "blocks_{}")):
        t, blk = f"blocks.{i}", enc[f"blocks_{i}"]
        _conv(e, f"{t}.dwconv", blk["dwconv"])
        _norm(e, f"{t}.norm", blk["norm"])
        _linear(e, f"{t}.pwconv1", blk["pwconv1"])
        _linear(e, f"{t}.pwconv2", blk["pwconv2"])
        e[f"{t}.grn.gamma"] = _t(blk["grn"]["gamma"])
        e[f"{t}.grn.beta"] = _t(blk["grn"]["beta"])
    vq: dict = {}
    _linear(vq, "project_in", q["project_in"])
    _linear(vq, "project_out", q["project_out"])
    return {"net": {"encoder": e, "vq": vq}}


def write_dit_v2(p: dict) -> dict:
    """A ``DiTV2`` tree -> the v2 CFM state dict (``estimator.*``)."""
    sd: dict = {}
    _linear(sd, "cond_projection", p["cond_projection"])
    _t_embedder(sd, "t_embedder", p["t_embedder"])
    _linear(sd, "cond_x_merge_linear", p["cond_x_merge_linear"])
    _linear(sd, "style_in", p["style_in"])
    _linear(sd, "final_mlp.0", p["final_mlp0"])
    _linear(sd, "final_mlp.2", p["final_mlp2"])
    _linear(sd, "transformer.norm.linear", p["final_adaln_linear"])
    sd["transformer.norm.norm.weight"] = _t(p["final_norm"]["weight"])
    for i in range(_count(p, "layers_{}")):
        t, layer = f"transformer.layers.{i}", p[f"layers_{i}"]
        _linear(sd, f"{t}.attention_norm.linear", layer["adaln_linear"])
        sd[f"{t}.attention_norm.norm.weight"] = _t(layer["attention_norm"]["weight"])
        sd[f"{t}.ffn_norm.weight"] = _t(layer["ffn_norm"]["weight"])
        for name in ("wqkv", "wo"):
            _linear(sd, f"{t}.attention.{name}", layer["attention"][name])
        for name in ("w1", "w2", "w3"):
            _linear(sd, f"{t}.feed_forward.{name}", layer["feed_forward"][name])
    return _prefixed(sd, "estimator.")


def is_identity(p: dict) -> bool:
    k, b = np.asarray(p["kernel"]), np.asarray(p["bias"])
    return k.shape[0] == k.shape[1] and (k == np.eye(k.shape[0])).all() and not b.any()


def write_regulator_v2(p: dict) -> dict:
    """A v2 ``InterpolateRegulator`` tree -> its state dict: an identity
    ``out_proj`` is the reference's ``nn.Identity`` (no weights), and the
    training-only ``mask_token`` is written."""
    sd: dict = {}
    if "embedding" in p:
        sd["embedding.weight"] = _t(p["embedding"]["embedding"])
    else:
        _linear(sd, "content_in_proj", p["content_in_proj"])
    n = _regulator_body(sd, p)
    if not is_identity(p["out_proj"]):
        _conv1x1(sd, f"model.{3 * n}", p["out_proj"])
    channels = np.asarray(p["out_proj"]["bias"]).shape[0]
    sd["mask_token"] = _t(np.zeros((1, channels), np.float32))
    if "f0_embedding" in p:
        sd["f0_embedding.weight"] = _t(p["f0_embedding"]["embedding"])
        sd["f0_mask"] = _t(p["f0_mask"])
    return sd


def write_ar(p: dict) -> dict:
    """An ``ARTransformer`` tree -> the ``NaiveWrapper`` state dict."""
    sd: dict = {"model.embeddings.weight": _t(p["embeddings"]["embedding"])}
    for i in range(_count(p, "layers_{}")):
        t, layer = f"model.layers.{i}", p[f"layers_{i}"]
        sd[f"{t}.attention_norm.weight"] = _t(layer["attention_norm"]["weight"])
        sd[f"{t}.ffn_norm.weight"] = _t(layer["ffn_norm"]["weight"])
        for name in ("wqkv", "wo"):
            _linear(sd, f"{t}.attention.{name}", layer["attention"][name])
        for name in ("w1", "w3", "w2"):
            _linear(sd, f"{t}.feed_forward.{name}", layer[f"feed_forward_{name}"])
    sd["model.norm.weight"] = _t(p["norm"]["weight"])
    _linear(sd, "model.output", p["output"])
    sd["sep_token_emb"] = _t(p["sep_token_emb"])
    return sd


def _vits_wn(sd, prefix, p):
    cond = p["cond_layer"]
    weight_norm(sd, f"{prefix}.cond_layer", np.asarray(cond["kernel"]).T[:, :, None])
    sd[f"{prefix}.cond_layer.bias"] = _t(cond["bias"])
    for i in range(_count(p, "in_layers_{}")):
        _wn_conv(sd, f"{prefix}.in_layers.{i}", p[f"in_layers_{i}"])
        _wn_conv(sd, f"{prefix}.res_skip_layers.{i}", p[f"res_skip_layers_{i}"])


def write_openvoice(p: dict) -> dict:
    """A ``ToneColorConverter`` tree -> the OpenVoice ``checkpoint.pth``
    content ``{'model': ...}``."""
    sd: dict = {}
    ref = p["ref_enc"]
    for i in range(_count(ref, "convs_{}")):
        _wn_conv(sd, f"ref_enc.convs.{i}", ref[f"convs_{i}"])
    _gru(sd, "ref_enc.gru", ref["gru"])
    _linear(sd, "ref_enc.proj", ref["proj"])
    _conv1x1(sd, "enc_q.pre", p["enc_q_pre"])
    _vits_wn(sd, "enc_q.enc", p["enc_q_wn"])
    _conv1x1(sd, "enc_q.proj", p["enc_q_proj"])
    flow = p["flow"]
    for i in range(_count(flow, "flows_{}")):
        t, f = f"flow.flows.{2 * i}", flow[f"flows_{i}"]
        _conv1x1(sd, f"{t}.pre", f["pre"])
        _vits_wn(sd, f"{t}.enc", f["enc"])
        _conv1x1(sd, f"{t}.post", f["post"])
    dec = p["dec"]
    _conv(sd, "dec.conv_pre", dec["conv_pre"])
    _conv1x1(sd, "dec.cond", dec["cond"])
    n_up = _count(dec, "ups_{}_kernel")
    n_kernels = _count(dec, "resblocks_0_{}")
    for i in range(n_up):
        _wn_transposed(sd, f"dec.ups.{i}", dec[f"ups_{i}_kernel"], dec[f"ups_{i}_bias"])
        for j in range(n_kernels):
            idx, blk = i * n_kernels + j, dec[f"resblocks_{i}_{j}"]
            for l in range(_count(blk, "convs1_{}")):
                _wn_conv(sd, f"dec.resblocks.{idx}.convs1.{l}", blk[f"convs1_{l}"])
                _wn_conv(sd, f"dec.resblocks.{idx}.convs2.{l}", blk[f"convs2_{l}"])
    _conv(sd, "dec.conv_post", dec["conv_post"])
    return {"model": sd}


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------
_SAFETENSORS_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
                      torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
                      torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
                      torch.bool: "BOOL"}


def save_safetensors(tensors: dict, path: str, metadata: dict | None = None):
    """Write ``tensors`` (name -> CPU tensor) as a ``.safetensors`` file: the
    header's JSON padded with spaces to 8 bytes, each tensor's bytes in name
    order."""
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


# each flag of apps.convert_checkpoint -> its file, under core/hub.py::MODEL_ZOO's
# names (HF snapshot directories for whisper, hubert and wavlm_sv)
ZOO_FILES = {"dit": "DiT_seed_v2_uvit_whisper_small_wavenet_bigvgan_pruned.pth",
             "campplus": "campplus_cn_common.bin", "bigvgan": "bigvgan_generator.pt",
             "whisper": os.path.join("whisper-small", "model.safetensors"),
             "rmvpe": "rmvpe.pt", "hift": "hift.pt",
             "openvoice": os.path.join("converter", "checkpoint.pth"),
             "wavlm_sv": os.path.join("wavlm-base-plus-sv", "pytorch_model.bin"),
             "astral_narrow": os.path.join("bsq32", "bsq32_light.pth"),
             "astral_wide": os.path.join("bsq2048", "bsq2048_light.pth"),
             "v2_cfm": os.path.join("v2", "cfm_small.pth"),
             "v2_ar": os.path.join("v2", "ar_base.pth"),
             "hubert": os.path.join("hubert-large", "pytorch_model.bin")}
# the flags whose CLI argument is the snapshot directory
DIR_FLAGS = ("whisper", "hubert", "wavlm_sv")
# tree names (VoiceConverter's *_params, VoiceConverterV2.PARAM_NAMES) -> flag, writer
WRITERS = {"campplus": ("campplus", write_campplus), "vocoder": ("bigvgan", write_bigvgan),
           "whisper": ("whisper", write_whisper), "rmvpe": ("rmvpe", write_rmvpe),
           "hift": ("hift", write_hift), "openvoice": ("openvoice", write_openvoice),
           "wavlm_sv": ("wavlm_sv", write_wavlm_sv), "narrow": ("astral_narrow", write_astral),
           "wide": ("astral_wide", write_astral),
           "ssl": ("hubert", lambda t: write_ssl(t, style="weight_g"))}


def zoo_contents(trees: dict, ema_vc: dict | None = None) -> dict:
    """The files' contents (CLI flag -> state dict or checkpoint) of a set
    of trees named as the converters' outputs: ``vc`` (with ``ema_vc`` as
    its EMA), ``dit`` + ``cfm_reg`` (v2 CFM), ``ar`` + ``ar_reg`` (v2 AR),
    and the names of :data:`WRITERS`."""
    out = {}
    if "vc" in trees:
        out["dit"] = write_vc_checkpoint(trees["vc"], ema_vc)
    if "dit" in trees:
        out["v2_cfm"] = {"net": {"cfm": write_dit_v2(trees["dit"]),
                                 "length_regulator": write_regulator_v2(trees["cfm_reg"])}}
    if "ar" in trees:
        out["v2_ar"] = {"net": {"ar": write_ar(trees["ar"]),
                                "length_regulator": write_regulator_v2(trees["ar_reg"])}}
    for name, (flag, write) in WRITERS.items():
        if name in trees:
            out[flag] = write(trees[name])
    return out


def write_zoo(out_dir: str, contents: dict) -> dict:
    """Write :func:`zoo_contents` under :data:`ZOO_FILES`' names (a
    ``.safetensors`` file by :func:`save_safetensors`, the rest by
    ``torch.save``); returns flag -> path."""
    paths = {}
    for flag, obj in contents.items():
        path = os.path.join(out_dir, ZOO_FILES[flag])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if path.endswith(".safetensors"):
            save_safetensors(obj, path, {"format": "pt"})
        else:
            torch.save(obj, path)
        paths[flag] = path
    return paths


def cli_args(paths: dict) -> list:
    """``--flag path`` pairs for ``apps.convert_checkpoint`` from
    :func:`write_zoo`'s result."""
    args = []
    for flag, path in paths.items():
        args += [f"--{flag.replace('_', '-')}",
                 os.path.dirname(path) if flag in DIR_FLAGS else path]
    return args
