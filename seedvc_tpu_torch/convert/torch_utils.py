"""Layout converters: torch state_dict tensors -> flax parameter arrays (port
of ``seedvc_tpu/convert/torch_utils.py``), and a ``.safetensors`` reader.

Conventions:
- torch Conv1d weight (out, in, k)      -> flax Conv kernel (k, in, out)
- torch Conv2d weight (out, in, kh, kw) -> flax Conv kernel (kh, kw, in, out)
- torch Linear weight (out, in)         -> flax Dense kernel (in, out)
- torch BatchNorm running stats         -> EvalBatchNorm {mean, var, scale, bias}
- weight-norm parameterizations (weight_g, weight_v) are folded into plain
  weights at conversion time (``fold_weight_norm``), in numpy f32 as the JAX
  package folds them, so both packages write the same trees bit for bit.

:func:`load_safetensors` reads a ``.safetensors`` file (an 8-byte
little-endian header length, a JSON header, then the raw tensor bytes) with
the standard library and torch alone, so converting needs no ``safetensors``
package.
"""

from __future__ import annotations

import json
import struct
import sys

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def conv1d_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 1, 0)


def conv2d_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def linear_kernel(w) -> np.ndarray:
    return _np(w).transpose(1, 0)


def bn_params(sd: dict, prefix: str, affine: bool = True) -> dict:
    out = {
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }
    if affine:
        out["scale"] = _np(sd[f"{prefix}.weight"])
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def fold_weight_norm(sd: dict, prefix: str) -> np.ndarray:
    """Fold torch weight_norm (weight_g, weight_v) into a plain weight.

    w = g * v / ||v||, with the norm over all dims except dim 0.
    """
    g = _np(sd[f"{prefix}.weight_g"])
    v = _np(sd[f"{prefix}.weight_v"])
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    return g * v / norm


SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, by name (the
    header's ``__metadata__``, string pairs, is skipped)."""
    if sys.byteorder != "little":
        raise RuntimeError("load_safetensors reads little-endian data on a "
                           "little-endian host only")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        shape, (begin, end) = info["shape"], info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(data) or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has data offsets {[begin, end]} that do "
                             f"not fit its shape {shape} and dtype {info['dtype']} in "
                             f"{len(data)} data bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin).reshape(shape)
        # the file's writer aligns each tensor to its item size; a copy where one did not
        out[name] = t.clone() if begin % dtype.itemsize else t
    return out
