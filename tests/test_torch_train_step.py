"""The port's optimizers and train / eval steps against the JAX package's.

- ``make_optimizer`` and ``make_multi_optimizer`` against the optax chains of
  ``seedvc_tpu.train.optim`` (with ``with_lr_scale``) over 3 updates: warmup
  schedule, clipping active (in the multi case for one module only), and
  ``set_lr_scale`` halving the LR after the first update.
- ``make_train_step`` against ``make_sharded_train_step`` on a one-device
  mesh, 3 steps on the same trees, batches and draws
  (``torch_port_helpers.jax_train_draws``): with the parameter EMA, and with
  distillation from a frozen teacher; metrics and parameters compared after
  every step. Then the bf16 compute dtype for one step.
- ``make_eval_step`` against ``make_sharded_eval_step``.

Tolerances: the optimizers 1e-6 relative to each leaf's scale (f32; the
order of the norm's sum differs); the steps' loss and grad norm 1e-4
relative, parameters and EMA 1e-5 times the largest parameter (f32: the
gradients agree to about 1e-6 relative and Adam divides by sqrt(nu)); bf16:
2e-4 relative on the loss and 1e-2 on the grad norm (bf16 rounds at other
places in the two frameworks; measured 3e-5 and 5e-3, while the f32 step's
loss and grad norm differ from the bf16 one's by 1.2e-3 and 2.5e-2, so the
limits tell the two compute types apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seedvc_tpu.models.vc import VCModel as JVCModel
from seedvc_tpu.parallel.mesh import make_mesh
from seedvc_tpu.train import optim as joptim
from seedvc_tpu.train.step import TrainState as JTrainState
from seedvc_tpu.train.step import make_sharded_eval_step, make_sharded_train_step
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.train import optim
from seedvc_tpu_torch.train.step import init_state, make_eval_step, make_train_step
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import (jax_train_draws, port_cfg, tiny_train_cfg, train_batch,
                                vc_tree)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# optimizers

SHAPES = {"cfm": {"a": (6, 5), "b": (7,)}, "length_regulator": {"c": (3, 4)}}


def _tree(rng, scale=1.0):
    return {m: {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


def _flat(tree):
    return {f"{m}.{k}": v for m, leaves in tree.items() for k, v in leaves.items()}


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_optimizer_matches_optax(kind):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    # cfm's gradients far above the clip norm, the regulator's below it
    grads = [{"cfm": {k: 30 * v for k, v in g["cfm"].items()},
              "length_regulator": {k: 0.01 * v for k, v in g["length_regulator"].items()}}
             for g in (_tree(rng) for _ in range(3))]
    j_sched = joptim.warmup_cosine(1e-2, 2, 5)
    p_sched = optim.warmup_cosine(1e-2, 2, 5)
    if kind == "single":
        jopt = joptim.with_lr_scale(joptim.make_optimizer(j_sched, grad_clip=1.0))
        popt = optim.make_optimizer(p_sched, grad_clip=1.0)
    else:
        jopt = joptim.with_lr_scale(joptim.make_multi_optimizer(j_sched, grad_clip=1.0))
        popt = optim.make_multi_optimizer(p_sched, grad_clip=1.0)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    pp = {n: torch.from_numpy(v.copy()) for n, v in _flat(params).items()}
    pstate = popt.init(pp)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        pupd, pstate = popt.update({n: torch.from_numpy(v) for n, v in _flat(g).items()},
                                   pstate, pp)
        optim.apply_updates(pp, pupd)
        if i == 0:
            jstate = joptim.set_lr_scale(jstate, 0.5 * joptim.get_lr_scale(jstate))
            pstate = optim.set_lr_scale(pstate, 0.5 * optim.get_lr_scale(pstate))
            assert optim.get_lr_scale(pstate) == joptim.get_lr_scale(jstate) == 0.5
        for n, ref in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
            np.testing.assert_allclose(pp[n].numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=f"{n} step {i}")


def test_schedules_match_optax():
    j, p = joptim.warmup_cosine(3e-4, 10, 50), optim.warmup_cosine(3e-4, 10, 50)
    je, pe = joptim.exponential(1e-4), optim.exponential(1e-4)
    for c in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(p(c), float(j(jnp.int32(c))), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(pe(c), float(je(jnp.int32(c))), rtol=1e-6)


# ---------------------------------------------------------------------------
# train and eval steps

MP = tiny_train_cfg().model_params


def _batches(n):
    return [train_batch(seed=10 + i) for i in range(n)]


def _jax_step_and_state(params, teacher, ema_decay, compute_dtype=None):
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    jopt = joptim.with_lr_scale(joptim.make_optimizer(joptim.warmup_cosine(1e-3, 2, 10)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32),
                        jax.tree_util.tree_map(jnp.array, jparams) if ema_decay else None)
    step = make_sharded_train_step(JVCModel(MP), jopt, mesh, teacher_params=teacher,
                                   weight_ema_decay=ema_decay, compute_dtype=compute_dtype)
    return step, state


def _port_step_and_state(params, teacher, ema_decay, keys, compute_dtype=None, noise_dtype=None):
    model = load_jax_params(VCModel(port_cfg(MP)), params)
    popt = optim.make_optimizer(optim.warmup_cosine(1e-3, 2, 10))

    def draws_fn(i, shape, device):
        return jax_train_draws(keys[i], shape[0], shape[1], shape[2],
                               MP.DiT.class_dropout_prob, dtype=noise_dtype)

    step = make_train_step(model, popt, teacher_params=teacher, weight_ema_decay=ema_decay,
                           compute_dtype=compute_dtype, draws_fn=draws_fn)
    return model, step, init_state(model, popt, ema=bool(ema_decay))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("variant", ["ema", "distill"])
def test_train_step_matches_jax(variant):
    params = vc_tree(MP, seed=3)
    teacher = vc_tree(MP, seed=4) if variant == "distill" else None
    ema_decay = 0.9 if variant == "ema" else 0.0
    keys = [jax.random.PRNGKey(40 + i) for i in range(3)]
    jstep, jstate = _jax_step_and_state(params, teacher, ema_decay)
    model, pstep, pstate = _port_step_and_state(params, teacher, ema_decay, keys)
    for i, b in enumerate(_batches(3)):
        jstate, jm = jstep(jstate, b, keys[i])
        pstate, pm = pstep(pstate, _torch_batch(b), i)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-4,
                                       err_msg=f"{name} step {i}")
    assert pstate.step == int(jstate.step) == 3
    ref = jax.tree_util.tree_map(np.asarray, jstate.params)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(ref))
    got = to_jax_params(model)
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    if ema_decay:
        jema = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.ema_params))
        pema = jax.tree_util.tree_leaves(to_jax_params(model, pstate.ema_params))
        for g, r in zip(pema, jema):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * scale)


def test_train_step_bf16_matches_jax():
    params = vc_tree(MP, seed=3)
    keys = [jax.random.PRNGKey(60)]
    jstep, jstate = _jax_step_and_state(params, None, 0.0, compute_dtype=jnp.bfloat16)
    _, pstep, pstate = _port_step_and_state(params, None, 0.0, keys,
                                            compute_dtype=torch.bfloat16,
                                            noise_dtype=jnp.bfloat16)
    b = _batches(1)[0]
    _, jm = jstep(jstate, b, keys[0])
    _, pm = pstep(pstate, _torch_batch(b), 0)
    for name, rtol in (("loss", 2e-4), ("grad_norm", 1e-2)):
        np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=rtol, err_msg=name)


def test_eval_step_matches_jax():
    params = vc_tree(MP, seed=5)
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    b = _batches(1)[0]
    key = jax.random.PRNGKey(9)
    j_loss = float(make_sharded_eval_step(JVCModel(MP), mesh)(
        jax.tree_util.tree_map(jnp.asarray, params), b, key))
    model = load_jax_params(VCModel(port_cfg(MP)), params)
    eval_fn = make_eval_step(model, draws_fn=lambda _k, s, _d: jax_train_draws(
        key, s[0], s[1], s[2], MP.DiT.class_dropout_prob))
    p_loss = float(eval_fn(dict(model.named_parameters()), _torch_batch(b), None))
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
