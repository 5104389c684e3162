"""Carry a flax parameter tree onto a port module.

The port's submodule names mirror the flax names (``layers_0``, ``wqkv``,
``resblocks_2_1``, ``act1_0``, ...), so the walk is mechanical. Layout rules:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in); the SplitDense
  kernel stays whole;
- Conv ``kernel`` (k, in, out) -> Conv1d ``weight`` (out, in, k), and
  (kh, kw, in, out) -> Conv2d (out, in, kh, kw);
- transposed-conv kernels ``ups_i_kernel`` (K, in, out) -> ConvTranspose1d
  ``ups_i.weight`` (in, out, K), and ``dec_i_up_kernel`` (kh, kw, in, out) ->
  ConvTranspose2d (in, out, kh, kw), unflipped (the JAX module flips it
  inside its dilated conv); a flax ``ConvTranspose`` (the ConvNeXt stage's
  ``up_conv_i``) lands the same way, and its port module flips it in time;
- GRU leaves ``w_ih`` (F, 3H), ``w_hh`` (H, 3H), ``b_ih``, ``b_hh`` -> a
  one-layer ``nn.GRU``'s ``weight_ih_l0`` (3H, F), ``weight_hh_l0``,
  ``bias_ih_l0``, ``bias_hh_l0`` (both gate orders are r, z, n);
- norms: ``scale`` -> ``weight``; EvalBatchNorm ``mean``/``var`` -> the
  ``running_mean``/``running_var`` buffers (1-D and 2-D alike);
- ``nn.Embed``'s ``embedding`` -> ``nn.Embedding.weight``;
- any other leaf (``alpha``, ``beta``, ``embed_positions``, ``weight``,
  ``f0_mask``, GRN's ``gamma``, the AR's ``sep_token_emb``) is copied as it
  is.

Every parameter and buffer of the module must be filled, or this raises;
BatchNorm's ``num_batches_tracked``, a training-time counter that holds no
weight, is the one exception. A tree entry without a place in the module
raises too, unless the module names it in ``unused_tree_entries`` (a
reference checkpoint's weights that the flax module ignores, such as an
unconditioned ``AdaptiveRMSNorm``'s ``project_layer``).

:func:`to_jax_params` is the inverse walk: a port module's parameters (or
any tensors named like them, such as their gradients) as a flax tree of
numpy arrays, which ``load_jax_params`` and the JAX package load. A
``weight`` becomes a Dense / Conv ``kernel``, an ``embedding``, a norm's
``scale`` or stays ``weight`` (RMSNorm) by the module that holds it; a
torch-style transposed convolution ``ups_i`` or ``dec_i_up`` becomes its
parent's ``ups_i_kernel`` / ``ups_i_bias``, the flax ``ConvTranspose`` of
the ConvNeXt stage (``FlaxConvTranspose1d``) its own ``kernel`` / ``bias``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var",
           "embedding": "weight"}
_GRU = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
        "b_hh": "bias_hh_l0"}


def _convert(mod: nn.Module, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if isinstance(mod, nn.GRU) and name in _GRU:
        return _GRU[name], arr.T
    if name != "kernel":
        return _RENAME.get(name, name), arr
    if isinstance(mod, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
        return "weight", arr.transpose(arr.ndim - 2, arr.ndim - 1, *range(arr.ndim - 2))
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
        return "weight", arr.transpose(arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2))
    return "weight", arr.T  # Dense / SplitDense


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``module`` in place from a flax ``params`` tree of numpy arrays."""
    filled: set[int] = set()

    def walk(mod: nn.Module, sub: Mapping, path: str):
        for name, value in sub.items():
            where = f"{path}/{name}"
            if name in getattr(mod, "unused_tree_entries", ()):
                continue
            if isinstance(value, Mapping):
                child = getattr(mod, name, None)
                if not isinstance(child, nn.Module):
                    raise KeyError(f"no submodule for {where}")
                walk(child, value, where)
                continue
            target, leaf = mod, name
            if ("_" in name and not hasattr(mod, name)
                    and name.rsplit("_", 1)[-1] in ("kernel", "bias")):
                base, leaf = name.rsplit("_", 1)
                target = getattr(mod, base, None)
                if not isinstance(target, nn.Module):
                    raise KeyError(f"no submodule for {where}")
            attr, arr = _convert(target, leaf, np.asarray(value))
            dest = getattr(target, attr, None)
            if not isinstance(dest, torch.Tensor):
                raise KeyError(f"no tensor for {where}")
            if tuple(dest.shape) != arr.shape:
                raise ValueError(f"{where}: shape {arr.shape} does not fit {tuple(dest.shape)}")
            with torch.no_grad():
                dest.copy_(torch.from_numpy(np.array(arr)))
            filled.add(id(dest))

    walk(module, tree, "")
    missing = [n for n, t in [*module.named_parameters(), *module.named_buffers()]
               if id(t) not in filled and not n.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"parameters not in the tree: {missing[:8]}")
    return module


_NORMS = (nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._NormBase)
# the port's own norm modules whose ``weight`` is a flax ``scale``
_NAMED_NORMS = ("MaskedGroupNorm", "EvalBatchNorm")
_INVERSE_RENAME = {"running_mean": "mean", "running_var": "var"}
_TRANSPOSED = (nn.ConvTranspose1d, nn.ConvTranspose2d)


def _to_flax(mod: nn.Module, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if isinstance(mod, _TRANSPOSED):
        if name != "weight":
            return name, arr
        perm = (arr.ndim - 2, arr.ndim - 1, *range(arr.ndim - 2))
        return "kernel", arr.transpose(np.argsort(perm))
    if isinstance(mod, nn.GRU):
        inverse = {v: k for k, v in _GRU.items()}
        return inverse[name], arr.T
    if name in _INVERSE_RENAME:
        return _INVERSE_RENAME[name], arr
    if name != "weight":
        return name, arr
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
        perm = (arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2))
        return "kernel", arr.transpose(np.argsort(perm))
    if isinstance(mod, nn.Embedding):
        return "embedding", arr
    if isinstance(mod, _NORMS) or type(mod).__name__ in _NAMED_NORMS:
        return "scale", arr
    if isinstance(mod, nn.Linear) or type(mod).__name__ == "SplitDense":
        return "kernel", arr.T
    return name, arr


def to_jax_params(module: nn.Module, values: Mapping | None = None) -> dict:
    """``module``'s parameters and buffers as a flax ``params`` tree of numpy
    arrays (f32 copies), the inverse of :func:`load_jax_params`. ``values``
    maps some of the module's parameter names (``named_parameters``) to
    tensors to write in their place, e.g. their gradients; None writes the
    parameters themselves."""
    if values is None:
        values = dict(module.named_parameters())
        values.update((n, b) for n, b in module.named_buffers()
                      if not n.endswith("num_batches_tracked"))
    tree: dict = {}
    for full, tensor in values.items():
        *path, leaf = full.split(".")
        mod = module.get_submodule(".".join(path))
        name, arr = _to_flax(mod, leaf, tensor.detach().float().cpu().numpy())
        if isinstance(mod, _TRANSPOSED) and type(mod).__name__ != "FlaxConvTranspose1d":
            name = f"{path.pop()}_{name}"  # a flat leaf of the parent
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree
