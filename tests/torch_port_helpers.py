"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py)."""

import jax
import numpy as np
import torch


def np_tree(tree):
    """A flax params tree with numpy leaves, as load_jax_params takes it."""
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init(module, *args, seed=0, **kwargs):
    """Random params for a flax module, drawn with numpy from the shapes of
    its init (no init compile): kernels ~ N(0, 1/fan_in), norm scales and
    BatchNorm variances near 1, other leaves ~ N(0, 0.1). Returns numpy."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1])) or 1
            a = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name in ("scale", "weight", "var"):
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(s.shape))
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_apply(module, params, *args, **kwargs):
    """``module.apply`` under jit (one compile instead of op-by-op dispatch)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kwargs))(params, *args)
