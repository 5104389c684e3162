"""BigVGAN torch checkpoint -> ``models.bigvgan.BigVGAN`` parameter tree (port
of ``seedvc_tpu/convert/bigvgan.py``).

Handles the ``nvidia/bigvgan_v2_*`` generator state_dicts (weight-normed:
``weight_g``/``weight_v`` pairs are folded into plain weights).
Reference layout: ``modules/bigvgan/bigvgan.py:280-385``.
"""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import _np, conv1d_kernel, fold_weight_norm
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig


def _wn_conv1d(sd: dict, prefix: str) -> dict:
    w = fold_weight_norm(sd, prefix)  # (out, in, k)
    out = {"kernel": w.transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def convert_bigvgan(sd: dict, cfg: BigVGANConfig) -> dict:
    # HF checkpoints store {'generator': state_dict}.
    if "generator" in sd:
        sd = sd["generator"]
    p: dict = {}
    p["conv_pre"] = _wn_conv1d(sd, "conv_pre")

    n_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        # ConvTranspose1d weight (in, out, K) -> (K, in, out).
        w = fold_weight_norm(sd, f"ups.{i}.0")
        p[f"ups_{i}_kernel"] = w.transpose(2, 0, 1)
        p[f"ups_{i}_bias"] = _np(sd[f"ups.{i}.0.bias"])

        for j in range(n_kernels):
            idx = i * n_kernels + j
            blk: dict = {}
            n_dil = len(cfg.resblock_dilation_sizes[j])
            for l in range(n_dil):
                blk[f"convs1_{l}"] = _wn_conv1d(sd, f"resblocks.{idx}.convs1.{l}")
                blk[f"convs2_{l}"] = _wn_conv1d(sd, f"resblocks.{idx}.convs2.{l}")
                # activations: interleaved [a1_0, a2_0, a1_1, a2_1, ...]
                for name, k in (("act1", 2 * l), ("act2", 2 * l + 1)):
                    act = {"alpha": _np(sd[f"resblocks.{idx}.activations.{k}.act.alpha"])}
                    bkey = f"resblocks.{idx}.activations.{k}.act.beta"
                    if bkey in sd:
                        act["beta"] = _np(sd[bkey])
                    blk[f"{name}_{l}"] = act
            p[f"resblocks_{i}_{j}"] = blk

    post = {"alpha": _np(sd["activation_post.act.alpha"])}
    if "activation_post.act.beta" in sd:
        post["beta"] = _np(sd["activation_post.act.beta"])
    p["activation_post"] = post
    p["conv_post"] = _wn_conv1d(sd, "conv_post")
    return p
