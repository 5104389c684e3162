"""The port's training losses against the JAX package's, on the same trees and
the same draws: ``VCModel.forward`` (regulators, prompt splice, ``CFM.forward``)
and its gradient with respect to every parameter, against JAX's
``value_and_grad`` of ``VCModel.__call__`` as the train step calls it.

The draws come from ``torch_port_helpers.jax_train_draws``, which replays the
JAX step's ``split(rng, 4)`` schedule. Cases: the classifier-free dropout mask
drawn (``class_dropout_prob`` 0.1) and not (0), an F0-conditioned regulator, the
VQ bottleneck with its 0.05 / 0.15 terms, and the discrete multi-codebook
regulator with ``random_n_quantizers``. The DiT runs flash attention: in the
port, the K1 twin forward and its autograd backward on the CPU (the JAX module
takes its einsum branch on the CPU; same math).

Tolerance: 1e-4 absolute on the loss, and on each gradient leaf 1e-4 times
the largest gradient of the tree (f32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.core import config as jc
from seedvc_tpu.models.regulator import InterpolateRegulator as JRegulator
from seedvc_tpu.models.regulator import random_n_quantizers as j_random_n_quantizers
from seedvc_tpu.models.vc import VCModel as JVCModel
from seedvc_tpu_torch.models.regulator import InterpolateRegulator, random_n_quantizers
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import (B, N_MELS, T, jax_init, jax_train_draws, port_cfg,
                                tiny_train_cfg, train_batch as batch, vc_tree)

torch.set_num_threads(1)

TOL = 1e-4


def jax_value_and_grad(mp, params, b, rng):
    model = JVCModel(mp)

    def loss_fn(p):
        keys = jax.random.split(rng, 4)
        rngs = {"prompt": keys[0], "t": keys[1], "noise": keys[2], "drop": keys[3]}
        loss, _ = model.apply({"params": p}, b["s_alt"], b["s_ori"], b["mels"],
                              b["mel_lens"], b["style"], rngs_dict=rngs, deterministic=True,
                              f0=b.get("f0"), s_lens=b.get("s_lens"),
                              f0_lens=b.get("f0_lens"))
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def port_value_and_grad(mp, params, b, draws):
    model = load_jax_params(VCModel(port_cfg(mp)), params)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, _ = model(t["s_alt"], t["s_ori"], t["mels"], t["mel_lens"], t["style"], draws,
                    f0=t.get("f0"), s_lens=t.get("s_lens"), f0_lens=t.get("f0_lens"))
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return float(loss.detach()), to_jax_params(model, grads)


def assert_trees_close(got, ref, tol=TOL):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_ref)
    scale = max(float(np.abs(v).max()) for _, v in flat_ref)
    assert scale > 0
    for path, r in flat_ref:
        np.testing.assert_allclose(flat_got[path], r, rtol=0, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))


CASES = {
    "cond_drop_on": dict(),
    "cond_drop_off": dict(dit=dict(class_dropout_prob=0.0)),
    "f0": dict(reg=dict(f0_condition=True, n_f0_bins=64),
               dit=dict(f0_condition=True, n_f0_bins=64)),
    "vq": dict(reg=dict(vector_quantize=True, content_codebook_size=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vc_loss_and_grads_match_jax(case):
    mp = tiny_train_cfg(**{k: dict(v) for k, v in CASES[case].items()}).model_params
    params = vc_tree(mp)
    b = batch(seed=1, f0=case == "f0")
    rng = jax.random.PRNGKey(31)  # drops sample 1's condition and zeroes its prompt
    draws = jax_train_draws(rng, B, T, N_MELS, mp.DiT.class_dropout_prob)
    assert bool(draws.prompt_zero[1])
    if mp.DiT.class_dropout_prob > 0:
        assert draws.cond_drop.tolist() == [0.0, 1.0]
    else:
        assert draws.cond_drop is None
    j_loss, j_grads = jax_value_and_grad(mp, params, b, rng)
    p_loss, p_grads = port_value_and_grad(mp, params, b, draws)
    assert abs(p_loss - j_loss) <= TOL, (p_loss, j_loss)
    assert_trees_close(p_grads, j_grads)
    if case == "vq":
        # the codebook learns only through the 0.15 codebook-loss term
        assert np.abs(p_grads["length_regulator"]["vq"]["codebook"]).sum() > 0


def test_random_n_quantizers_and_multi_codebook_regulator():
    """``random_n_quantizers`` on JAX's drawn counts, then the discrete
    three-codebook regulator gated by them: output and gradients."""
    lcfg = jc.LengthRegulatorConfig(channels=32, is_discrete=True, content_codebook_size=40,
                                    n_codebooks=3, quantizer_dropout=0.5, sampling_ratios=(1,))
    key = jax.random.PRNGKey(7)
    jn = np.asarray(j_random_n_quantizers(key, 8, 3, 0.5))
    counts = torch.from_numpy(np.array(jax.random.randint(key, (8,), 1, 4)))
    pn = random_n_quantizers(counts, 3, 0.5)
    np.testing.assert_array_equal(pn.numpy(), jn)

    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 40, (8, 3, 20)).astype(np.int32)
    ylens = np.array([30, 28, 30, 25, 30, 30, 29, 30], np.int32)
    jreg = JRegulator(lcfg)
    params = jax_init(jreg, jnp.zeros((1, 3, 20), jnp.int32), jnp.full((1,), 30, jnp.int32),
                      30, seed=2)
    w = rng.standard_normal((8, 32, 32)).astype(np.float32)

    def jloss(p):
        out = jreg.apply({"params": p}, tokens, ylens, 32, n_quantizers=jnp.asarray(jn))[0]
        return jnp.sum(out * w)

    j_val, j_grads = jax.value_and_grad(jloss)(params)
    preg = load_jax_params(InterpolateRegulator(port_cfg(lcfg)), params)
    out = preg(torch.from_numpy(tokens).long(), torch.from_numpy(ylens), 32,
               n_quantizers=pn)[0]
    p_val = (out * torch.from_numpy(w)).sum()
    p_val.backward()
    assert abs(float(p_val.detach()) - float(j_val)) <= TOL * max(1.0, abs(float(j_val)))
    grads = {n: p.grad for n, p in preg.named_parameters()}
    assert_trees_close(to_jax_params(preg, grads), jax.tree_util.tree_map(np.asarray, j_grads))
