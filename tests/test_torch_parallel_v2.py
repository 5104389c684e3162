"""The port's v2 trainer on a (data, model) mesh against JAX's v2 trainer
and against its own one-process step.

A 4-rank gloo world (``torch_parallel_worker.case_v2_steps``) runs
``TrainerV2`` at (n_data, n_model) = (2, 2) (one batch row a rank; the
DiT's and the AR's attention and the DiT's FFN split over ``model``) and
(1, 4) (the AR's 2 KV heads do not split over 4, so its attention stays
whole, as JAX's divisibility rule leaves it), each with ``fsdp`` off and on
(the parameters of 1024 elements or more scattered over ``data``: the
trainer's floor of 65536 is above every parameter of this tiny model).
(4, 1) needs a batch of 4, which JAX's counterpart does not take (its
``batch_size % n_data`` check). Each rank prepares its rows of the batch
and takes three steps with JAX's draws (the whole batch's, cut to its
rows); the reference is JAX's ``TrainerV2(n_model=4)`` step
(``tests/test_torch_trainer_v2_steps.py``: ``_step_impl`` jitted on one
device, from the same trees on the port's prepared batch) and the port's
one-process trainer on the same batch and draws. Warmup over 2 steps and a
global clip below every step's norm, as there. Tolerance (f32): against
JAX, the first step's losses and norm 1e-5 relative and every parameter
after the third 1e-5 times the largest one; against the one process, the
losses and norms of all three steps 1e-6 relative and the parameters 2e-6
times the largest one (the ranks sum in another order and Adam divides each
gradient by its own size; see tests/test_torch_parallel_step.py).
"""

import jax
import numpy as np
import torch

from seedvc_tpu_torch.weights import to_jax_params
from test_torch_trainer_v2_steps import SEED, TCFG, jax_steps, jax_trainer, port_trainer
from torch_parallel_worker import _flat, start
from torch_port_helpers import jax_v2_chain_draws, v2_batch, v2_port_cfg

torch.set_num_threads(1)

STEPS = 3
MESHES = [(2, 2, False), (2, 2, True), (1, 4, False), (1, 4, True)]


def test_v2_steps_on_a_mesh_match_jax_and_one_process(tmp_path):
    jcfg, trainable, jtr = jax_trainer()
    ptr = port_trainer(jcfg, trainable)
    batch = v2_batch()
    feats, dims = ptr.prepare_batch(batch)
    draws_fn = jax_v2_chain_draws(jcfg.dit.class_dropout_prob)
    shape = tuple(feats["mels"].shape)
    draws = [tuple(d.numpy() for d in draws_fn((SEED, i), shape, None)) for i in range(STEPS)]
    wait = start("v2_steps", 4, tmp_path, dict(
        vcfg=v2_port_cfg(jcfg), tcfg=TCFG, trainable=trainable, batch=batch, draws=draws,
        meshes=MESHES, steps=STEPS, fsdp_min_elems=1024), timeout=150)
    jstate, jm = jax_steps(jtr, trainable, feats, dims, STEPS)
    one = [{k: float(v) for k, v in ptr._device_step(feats, dims, (SEED, i)).items()}
           for i in range(STEPS)]
    ref_one = _flat(to_jax_params(ptr.model))
    ref_jax = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    results = wait()
    for mesh in MESHES:
        got = results[mesh]
        assert bool(got["fsdp"]) == mesh[2], mesh
        # the AR's attention splits over 2 ranks, not over 4
        assert any(n.startswith("ar.") for n in got["tp"]) == (mesh[1] == 2), mesh
        assert any(n.startswith("dit.") for n in got["tp"]), mesh
        for k in jm[0]:
            np.testing.assert_allclose(got["metrics"][0][k], jm[0][k], rtol=1e-5,
                                       err_msg=f"{mesh} {k}")
        for i in range(STEPS):
            for k, v in one[i].items():
                np.testing.assert_allclose(got["metrics"][i][k], v, rtol=1e-6,
                                           err_msg=f"{mesh} {k} {i}")
        # the parameters after the last step: the one process's, and JAX's
        assert set(got["params"]) == set(ref_one) == set(ref_jax)
        for ref, tol in ((ref_one, 2e-6), (ref_jax, 1e-5)):
            scale = max(float(np.abs(v).max()) for v in ref.values())
            for n, r in ref.items():
                np.testing.assert_allclose(got["params"][n], r, rtol=0, atol=tol * scale,
                                           err_msg=f"{mesh} {n}")
