"""A distillation step of the port's v2 trainer against the JAX trainer's:
the teacher is the student's trees perturbed, both terms on
(``distill_cfm``, ``distill_ar``), the same prepared batch and JAX's draws
for student and teacher. Held: every metric (``loss_distill`` among them,
``loss = loss_cfm + loss_ar + loss_distill``) and the parameters after the
step; and a teacher equal to the student distils nothing.

Tolerance (f32): losses and norms 1e-5 relative, parameters 1e-5 times the
largest one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_trainer_v2_steps import (RTOL, SEED, check_params, jax_steps, jax_trainer,
                                         port_trainer)
from torch_port_helpers import v2_batch

torch.set_num_threads(1)


def test_distillation_step_matches_jax():
    jcfg, trainable, jtr = jax_trainer(distill_cfm=True, distill_ar=True)
    rng = np.random.default_rng(9)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), trainable)
    ptr = port_trainer(jcfg, trainable, teacher=teacher, distill_cfm=True, distill_ar=True)
    feats, dims = ptr.prepare_batch(v2_batch(seed=1))
    jstate, jm = jax_steps(jtr, trainable, feats, dims, 1,
                           teacher=jax.tree_util.tree_map(jnp.asarray, teacher))
    pm = {k: float(v) for k, v in ptr._device_step(feats, dims, (SEED, 0)).items()}
    assert set(pm) == set(jm[0]) and pm["loss_distill"] > 0
    for k in jm[0]:
        np.testing.assert_allclose(pm[k], jm[0][k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(pm["loss"], pm["loss_cfm"] + pm["loss_ar"] + pm["loss_distill"],
                               rtol=1e-6)
    check_params(ptr, jstate.params)

    # a teacher equal to the student: the same losses on the same draws
    same = port_trainer(jcfg, trainable, teacher=trainable, distill_cfm=True, distill_ar=True)
    m = same._device_step(feats, dims, (SEED, 0))
    assert float(m["loss_distill"]) < 1e-9
