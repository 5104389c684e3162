"""The port's sharded v1 train step (``make_sharded_train_step`` after
``shard_state``) against JAX's on its 8-device CPU mesh and against the
port's one-process ``make_train_step``.

One 4-rank gloo world (``torch_parallel_worker.case_v1_steps``) takes one
step at (n_data, n_model) = (4, 1), (2, 2) and (1, 4), each with ``fsdp``
off and on, on the same global batch of 4 rows, JAX's draws, a distillation
teacher and the parameter EMA; the DiT has 4 heads, so ``model`` splits
its attention and FFN, and with ``fsdp`` every parameter of at least 1024
elements is scattered over ``data``. JAX's reference is its sharded step on
``make_mesh(2, 2, devices[:4])``: a sharding is a layout choice there, so one
mesh stands for all. The LR is constant (a warmup would give the first
step LR 0) and the clip is below the gradient norm, so the clip's global
norm enters the update.

Tolerances (f32): against JAX, the loss and grad norm 1e-5 relative and the
parameters and EMA 1e-5 times the largest parameter (the existing
one-device parity's, ``test_torch_train_step.py``); against the one-process
port step, the loss and grad norm 1e-6 relative and the parameters and EMA
1e-6 times the largest parameter, except the elements whose one-process
gradient is below Adam's ``eps`` (1e-6), held at 2e-6. Adam's first update
of an element is ``-lr * g / (|g| + eps)``, which moves by up to
``lr / eps`` = 1000 times a rounding of ``g`` when ``|g|`` is below
``eps``; the ranks sum the batch in another order, and so does the one
process on the same rows reordered, which the test holds to the same
limits. On this batch (``pytest -s`` prints it): the reordered one-process
step deviates by up to 9.2e-7 times the largest parameter where the
gradient is below eps and 1.3e-7 elsewhere; the meshes by up to 1.6e-6 and
7.2e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from seedvc_tpu.models.vc import VCModel as JVCModel
from seedvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seedvc_tpu.train import optim as joptim
from seedvc_tpu.train.step import TrainState as JTrainState
from seedvc_tpu.train.step import make_sharded_train_step as jax_sharded_step
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.train import optim
from seedvc_tpu_torch.train.step import init_state, make_train_step
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_parallel_worker import _flat, start
from torch_port_helpers import jax_train_draws, port_cfg, tiny_train_cfg, vc_tree

torch.set_num_threads(1)

MP = tiny_train_cfg(dit=dict(num_heads=4)).model_params
B, T, T_S = 4, 48, 24
LR, CLIP, EMA = 1e-3, 2.0, 0.9
EPS = 1e-6  # make_optimizer's Adam eps
MESHES = [(4, 1, False), (2, 2, False), (1, 4, False), (4, 1, True), (2, 2, True), (1, 4, True)]


def _batch():
    rng = np.random.default_rng(1)
    return {"s_alt": rng.standard_normal((B, T_S, 48)).astype(np.float32),
            "s_ori": rng.standard_normal((B, T_S, 48)).astype(np.float32),
            "mels": rng.standard_normal((B, T, 80)).astype(np.float32) - 4.0,
            # unequal lengths: the regulator's interpolation length is the
            # global batch's longest, which no rank of (4, 1) holds alone
            "mel_lens": np.array([41, 37, 48, 45], np.int32),
            "style": rng.standard_normal((B, 192)).astype(np.float32),
            "s_lens": np.array(21, np.int32)}


def _jax_step(params, teacher, batch, key):
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    jopt = joptim.with_lr_scale(joptim.make_optimizer(LR, grad_clip=CLIP))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = JTrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32),
                        jax.tree_util.tree_map(jnp.array, jp))
    step = jax_sharded_step(JVCModel(MP), jopt, mesh, teacher_params=teacher,
                            weight_ema_decay=EMA)
    state, m = step(state, batch, key)
    return {**{k: float(v) for k, v in m.items()},
            "params": _flat(jax.tree_util.tree_map(np.asarray, state.params)),
            "ema": _flat(jax.tree_util.tree_map(np.asarray, state.ema_params))}


def _port_step(params, teacher, batch, draws):
    model = load_jax_params(VCModel(port_cfg(MP)), params)
    opt = optim.make_optimizer(LR, grad_clip=CLIP)
    state = init_state(model, opt, ema=True)
    step = make_train_step(model, opt, teacher_params=teacher, weight_ema_decay=EMA,
                           draws_fn=lambda *_: draws)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {**{k: float(m[k]) for k in ("loss", "grad_norm")},
            "params": _flat(to_jax_params(model)),
            "ema": _flat(to_jax_params(model, state.ema_params)),
            "grads": _flat(to_jax_params(model, grads))}


def _close(got, ref, rtol, what, grads=None):
    """Loss and grad norm within ``rtol``, parameters and EMA within ``rtol``
    times the largest parameter; with ``grads``, twice that where the
    gradient is below Adam's eps. Returns the worst parameter deviation
    over the largest parameter, where the gradient is below eps and where
    it is not (printed with ``pytest -s``)."""
    scale = max(float(np.abs(v).max()) for v in ref["params"].values())
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, err_msg=f"{what} {k}")
    worst = {"below eps": 0.0, "eps or more": 0.0}
    for tree in ("params", "ema"):
        assert set(got[tree]) == set(ref[tree])
        for n, r in ref[tree].items():
            dev = np.abs(got[tree][n] - r)
            tol = np.full(r.shape, rtol * scale, np.float32)
            if grads is not None:
                small = np.abs(grads[n]) < EPS
                tol[small] *= 2
                for key, m in (("below eps", small), ("eps or more", ~small)):
                    if m.any():
                        worst[key] = max(worst[key], float(dev[m].max()) / scale)
            bad = dev > tol
            assert not bad.any(), (f"{what} {tree} {n}: {int(bad.sum())} elements off, worst "
                                   f"{float(dev.max()) / scale:.3g} x scale")
    return worst


def test_sharded_steps_match_jax_and_one_process(tmp_path):
    params, teacher = vc_tree(MP, seed=3), vc_tree(MP, seed=4)
    batch, key = _batch(), jax.random.PRNGKey(40)
    draws = jax_train_draws(key, B, T, 80, MP.DiT.class_dropout_prob)
    wait = start("v1_steps", 4, tmp_path, dict(
        mp=port_cfg(MP), params=params, teacher=teacher, batch=batch, meshes=MESHES,
        draws=tuple(None if d is None else d.numpy() for d in draws), fsdp_min_elems=1024,
        grad_clip=CLIP))
    jax_ref = _jax_step(params, teacher, batch, key)
    one_ref = _port_step(params, teacher, batch, draws)
    # the same step in one process on the rows reordered: only the order of
    # the sums differs, as it does between the meshes
    perm = np.array([1, 0, 3, 2])
    reordered = _port_step(params, teacher, {k: v[perm] if v.ndim else v for k, v in batch.items()},
                           type(draws)(*(d if d is None or d.ndim == 0 else d[perm]
                                         for d in draws)))
    print("one process, reordered rows:",
          _close(reordered, one_ref, 1e-6, "one process on reordered rows", grads=one_ref["grads"]))
    got = wait()
    assert jax_ref["grad_norm"] > CLIP  # the clip acted
    _close(one_ref, jax_ref, 1e-5, "one process vs JAX")
    n_attn = sum(n.endswith("attention.wqkv.weight") for n in dict(VCModel(port_cfg(MP))
                                                                    .named_parameters()))
    for mesh in MESHES:
        out = got[mesh]
        # the split really happened: 3 layers x (wqkv, wo, w1, w3, w2) over
        # model, and with fsdp the large parameters over data
        assert len(out["tp"]) == (5 * n_attn if mesh[1] > 1 else 0), mesh
        assert (len(out["fsdp"]) > 20) == mesh[2], mesh
        _close(out, jax_ref, 1e-5, f"{mesh} vs JAX")
        print(f"{mesh}:", _close(out, one_ref, 1e-6, f"{mesh} vs one process",
                                 grads=one_ref["grads"]))
