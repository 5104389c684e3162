"""Steps of the port's v2 trainer against the JAX trainer's, from the same
flax trees, on the same prepared batch and JAX's draws (the port's
``draws_fn`` replays the JAX loop's key chain, ``jax_v2_chain_draws``):

three steps with warmup and the global clip active (``grad_clip`` below
every step's norm): the first step's ``loss_cfm``, ``loss_ar``, ``loss`` and
``grad_norm``, then every parameter after the third. The distillation step
is held in tests/test_torch_trainer_v2_distill.py.

The JAX step is ``TrainerV2._step_impl`` jitted on one device (the SPMD
train step compiles slowly). Tolerance (f32): losses and norms 1e-5
relative, parameters 1e-5 times the largest one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from seedvc_tpu.train.trainer_v2 import TrainerV2 as JTrainerV2
from seedvc_tpu.train.trainer_v2 import TrainerV2Config as JTrainerV2Config
from seedvc_tpu.train.trainer_v2 import V2TrainState as JState
from seedvc_tpu_torch.train.trainer_v2 import TrainerV2, TrainerV2Config
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from test_trainer_v2 import tiny_v2cfg
from torch_port_helpers import jax_v2_chain_draws, v2_batch, v2_port_cfg, v2_trees

torch.set_num_threads(1)

RTOL = 1e-5
SEED = 1234
# warmup over 2 steps and a clip that every step's norm exceeds
TCFG = dict(batch_size=2, mel_bucket=64, token_bucket=32, warmup_steps=2, max_steps=10,
            base_lr=1e-3, grad_clip=0.5, seed=SEED)
DIMS = ("mel_T", "ar_C", "ar_X", "tok_T")


# The JAX trainer's frozen encoders are not run here (both steps take the
# port's prepared batch): placeholders spare their init compiles.
UNUSED_FROZEN = {name: {"unused": 0} for name in ("ssl", "narrow", "wide", "campplus")}


def jax_trainer(**over):
    """(JAX config, trainable flax trees, JAX TrainerV2 on the 8-device CPU
    mesh with n_model=4)."""
    jcfg = tiny_v2cfg()
    _, trainable = v2_trees(jcfg, frozen=False)
    jtr = JTrainerV2(jcfg, JTrainerV2Config(**{**TCFG, **over}), frozen_params=UNUSED_FROZEN,
                     n_model=4)
    return jcfg, trainable, jtr


def port_trainer(jcfg, trainable, teacher=None, **over):
    """The port's TrainerV2 on the CPU with JAX's draws (its own random
    frozen encoders) and the trainable trees loaded."""
    tr = TrainerV2(v2_port_cfg(jcfg), TrainerV2Config(**{**TCFG, **over}),
                   teacher_params=teacher, device="cpu",
                   draws_fn=jax_v2_chain_draws(jcfg.dit.class_dropout_prob))
    load_jax_params(tr.model, trainable)
    return tr


def jax_steps(jtr, trainable, feats, dims, n, teacher=None):

    """n JAX steps from ``trainable`` with the loop's key chain."""
    params = jax.tree_util.tree_map(jnp.asarray, trainable)
    state = JState(params, jtr.optimizer.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(jtr._step_impl, static_argnames=DIMS)
    feats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    key, metrics = jax.random.PRNGKey(SEED), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        state, m = step(state, feats, sub, teacher, **dims)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def check_params(ptr, jparams):
    ref = jax.tree_util.tree_map(np.asarray, jparams)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(ref))
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(ptr.model)))
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(got) == len(leaves)
    for path, r in leaves:
        np.testing.assert_allclose(got[path], r, rtol=0, atol=RTOL * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_three_steps_match_jax():
    jcfg, trainable, jtr = jax_trainer()
    ptr = port_trainer(jcfg, trainable)
    feats, dims = ptr.prepare_batch(v2_batch())
    jstate, jm = jax_steps(jtr, trainable, feats, dims, 3)
    pm = []
    for i in range(3):
        pm.append({k: float(v) for k, v in ptr._device_step(feats, dims, (SEED, i)).items()})
    assert set(pm[0]) == set(jm[0]) == {"loss", "loss_cfm", "loss_ar", "grad_norm"}
    for k in jm[0]:
        np.testing.assert_allclose(pm[0][k], jm[0][k], rtol=RTOL, err_msg=k)
    assert min(m["grad_norm"] for m in jm) > TCFG["grad_clip"]  # the clip was active
    assert ptr.state.step == int(jstate.step) == 3
    check_params(ptr, jstate.params)
