"""v2 CFM checkpoint conversion: torch DiT (AdaLN-Zero) + v2 regulators (port
of ``seedvc_tpu/convert/dit_v2.py``).

Maps the reference v2 CFM checkpoint (``modules/v2/dit_wrapper.py`` DiT
inside ``modules/v2/cfm.py`` CFM — state-dict keys ``estimator.*``) onto
``seedvc_tpu_torch.models.dit_v2.DiTV2`` params, and the v2
``modules/v2/length_regulator.py`` InterpolateRegulator onto
``seedvc_tpu_torch.models.regulator.InterpolateRegulator`` params.

Key layout notes:

- ``cond_x_merge_linear``: the reference concatenates ``[x, prompt_x,
  cond]`` (``dit_wrapper.py:131-136``); our SplitDense shares one
  ``(total_in, hidden)`` kernel with the same row order, so a plain
  transpose converts it.
- transformer blocks: ``attention_norm`` is the 6-way AdaLN (linear +
  RMSNorm), ``ffn_norm`` a PLAIN RMSNorm (``dit_model.py:123-144``) —
  unlike v1 where both norms are adaptive.
- ``x_embedder`` exists in the reference state dict but is UNUSED in its
  forward (``dit_wrapper.py:117-152``) — skipped.
- v2 regulators append ``nn.Identity`` instead of the 1x1 out conv when
  ``channels == out_channels`` (``length_regulator.py:52-55``); our
  regulator always applies ``out_proj``, so the converter synthesises an
  identity kernel in that case.
"""

from __future__ import annotations

import numpy as np

from seedvc_tpu_torch.convert.dit import _lin, _t_embedder, strip_prefixes
from seedvc_tpu_torch.convert.torch_utils import _np
from seedvc_tpu_torch.core.config import LengthRegulatorConfig
from seedvc_tpu_torch.models.dit_v2 import DiTV2Config


def convert_dit_v2(sd: dict, cfg: DiTV2Config) -> dict:
    """v2 CFM state_dict (keys ``estimator.*`` or bare) -> DiTV2 params."""
    sd = strip_prefixes(sd)
    if any(k.startswith("estimator.") for k in sd):
        sd = {k[len("estimator."):]: v for k, v in sd.items()
              if k.startswith("estimator.")}
    p: dict = {
        "cond_projection": _lin(sd, "cond_projection"),
        "t_embedder": _t_embedder(sd, "t_embedder"),
        "cond_x_merge_linear": _lin(sd, "cond_x_merge_linear"),
        "style_in": _lin(sd, "style_in"),
        "final_mlp0": _lin(sd, "final_mlp.0"),
        "final_mlp2": _lin(sd, "final_mlp.2"),
        "final_adaln_linear": _lin(sd, "transformer.norm.linear"),
        "final_norm": {"weight": _np(sd["transformer.norm.norm.weight"])},
    }
    for i in range(cfg.depth):
        t = f"transformer.layers.{i}"
        p[f"layers_{i}"] = {
            "adaln_linear": _lin(sd, f"{t}.attention_norm.linear"),
            "attention_norm": {
                "weight": _np(sd[f"{t}.attention_norm.norm.weight"])},
            "ffn_norm": {"weight": _np(sd[f"{t}.ffn_norm.weight"])},
            "attention": {"wqkv": _lin(sd, f"{t}.attention.wqkv", bias=False),
                          "wo": _lin(sd, f"{t}.attention.wo", bias=False)},
            "feed_forward": {
                "w1": _lin(sd, f"{t}.feed_forward.w1", bias=False),
                "w2": _lin(sd, f"{t}.feed_forward.w2", bias=False),
                "w3": _lin(sd, f"{t}.feed_forward.w3", bias=False)},
        }
    return p


def convert_regulator_v2(sd: dict, lr: LengthRegulatorConfig) -> dict:
    """v2 length-regulator state_dict -> InterpolateRegulator params.

    The v2 module always owns an ``embedding`` table (discrete tokens) and
    a ``mask_token`` (training-only; unused at inference — dropped)."""
    sd = strip_prefixes(sd)
    p: dict = {}
    if lr.is_discrete:
        p["embedding"] = {"embedding": _np(sd["embedding.weight"])}
    else:
        p["content_in_proj"] = _lin(sd, "content_in_proj")
    n = len(lr.sampling_ratios)
    for i in range(n):
        w = _np(sd[f"model.{3 * i}.weight"])  # (out, in, 3)
        p[f"conv_{i}"] = {"kernel": w.transpose(2, 1, 0),
                          "bias": _np(sd[f"model.{3 * i}.bias"])}
        p[f"norm_{i}"] = {"scale": _np(sd[f"model.{3 * i + 1}.weight"]),
                          "bias": _np(sd[f"model.{3 * i + 1}.bias"])}
    if f"model.{3 * n}.weight" in sd:
        w = _np(sd[f"model.{3 * n}.weight"])  # (out, in, 1)
        p["out_proj"] = {"kernel": w[:, :, 0].T,
                         "bias": _np(sd[f"model.{3 * n}.bias"])}
    else:
        # reference appended nn.Identity (channels == out_channels)
        p["out_proj"] = {"kernel": np.eye(lr.channels, dtype=np.float32),
                         "bias": np.zeros(lr.channels, np.float32)}
    if lr.f0_condition:
        p["f0_embedding"] = {"embedding": _np(sd["f0_embedding.weight"])}
        p["f0_mask"] = _np(sd["f0_mask"]).reshape(1, -1)
    return p
