"""v2 AR (NaiveWrapper) torch checkpoint -> ``models.ar.ARTransformer`` params
(port of ``seedvc_tpu/convert/ar.py``)."""

from __future__ import annotations

from seedvc_tpu_torch.convert.torch_utils import _np, linear_kernel


def convert_ar(sd: dict, n_layers: int) -> dict:
    """sd: NaiveWrapper state_dict (keys 'model.*' + 'sep_token_emb')."""
    p: dict = {
        "embeddings": {"embedding": _np(sd["model.embeddings.weight"])},
        "norm": {"weight": _np(sd["model.norm.weight"])},
        "output": {"kernel": linear_kernel(sd["model.output.weight"])},
        "sep_token_emb": _np(sd["sep_token_emb"]),
    }
    for i in range(n_layers):
        t = f"model.layers.{i}"
        p[f"layers_{i}"] = {
            "attention_norm": {"weight": _np(sd[f"{t}.attention_norm.weight"])},
            "ffn_norm": {"weight": _np(sd[f"{t}.ffn_norm.weight"])},
            "attention": {
                "wqkv": {"kernel": linear_kernel(sd[f"{t}.attention.wqkv.weight"])},
                "wo": {"kernel": linear_kernel(sd[f"{t}.attention.wo.weight"])},
            },
            "feed_forward_w1": {"kernel": linear_kernel(sd[f"{t}.feed_forward.w1.weight"])},
            "feed_forward_w3": {"kernel": linear_kernel(sd[f"{t}.feed_forward.w3.weight"])},
            "feed_forward_w2": {"kernel": linear_kernel(sd[f"{t}.feed_forward.w2.weight"])},
        }
    return p
