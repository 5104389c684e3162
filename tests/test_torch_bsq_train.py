"""BSQ's training half in the port against the JAX package's, on the same
random weights and seeded inputs: ``BSQ(training=True)`` with and without
the commitment term (and with a codebook scale, a temperature and a
diversity weight away from 1), ``spherical=False``, and
``GroupedResidualBSQ``. Held: the output, the indices (equal), the aux loss
and the gradients of ``sum(out * w) + sum(aux)`` with respect to every
parameter, ``project_in``'s among them (the straight-through estimator
passes the gradient to it). ``pmean_axis`` (codebook statistics across
devices) is held in tests/test_torch_parallel_collectives.py.

Tolerance (f32): outputs and aux 1e-5 absolute, gradients 1e-5 relative to
the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.nn import bsq as jbsq
from seedvc_tpu_torch.nn import bsq
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import jax_init

torch.set_num_threads(1)
TOL = 1e-5

BSQ_CASES = {
    "entropy": dict(),
    "commitment": dict(commitment_loss_weight=0.25),
    "scaled": dict(codebook_scale=1.7, inv_temperature=0.6, diversity_gamma=0.5,
                   entropy_loss_weight=0.3, commitment_loss_weight=0.1),
    "not_spherical": dict(spherical=False, commitment_loss_weight=0.25),
}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(jm, pm, x, seed):
    """Forward and gradients of both modules on x; aux summed into the loss."""
    params = jax_init(jm, x, training=True, seed=seed)
    w = _x(seed + 100, *x.shape)

    def jloss(p):
        out, _, aux = jm.apply({"params": p}, x, training=True)
        return jnp.sum(out * w) + jnp.sum(aux), (out, aux)

    (_, (j_out, j_aux)), j_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    _, j_idx, _ = jm.apply({"params": params}, x, training=True)
    load_jax_params(pm, params)
    p_out, p_idx, p_aux = pm(torch.from_numpy(x), training=True)
    (torch.sum(p_out * torch.from_numpy(w)) + p_aux.sum()).backward()
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(p_out.detach().numpy(), np.asarray(j_out), atol=TOL, rtol=0)
    np.testing.assert_allclose(p_aux.detach().numpy(), np.asarray(j_aux), atol=TOL, rtol=0)
    got = to_jax_params(pm, {n: q.grad for n, q in pm.named_parameters()})
    ref = jax.tree_util.tree_map(np.asarray, j_grads)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(ref))
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_allclose(flat[path], r, atol=TOL * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    return np.asarray(j_aux), got


@pytest.mark.parametrize("case", sorted(BSQ_CASES))
def test_bsq_training_matches_jax(case):
    kw = BSQ_CASES[case]
    x = _x(1, 2, 9, 16)
    aux, grads = _compare(jbsq.BSQ(dim=16, codebook_size=16, **kw),
                          bsq.BSQ(16, 16, **kw), x, seed=3)
    assert np.isfinite(aux) and np.abs(grads["project_in"]["kernel"]).sum() > 0


def test_commitment_adds_to_the_aux_loss():
    x = torch.from_numpy(_x(2, 2, 6, 16))
    plain, commit = bsq.BSQ(16, 16), bsq.BSQ(16, 16, commitment_loss_weight=0.25)
    commit.load_state_dict(plain.state_dict())
    with torch.no_grad():
        assert float(commit(x, training=True)[2]) > float(plain(x, training=True)[2])
    assert float(plain(x)[2]) == 0.0  # no aux loss outside training


def test_grouped_residual_bsq_matches_jax():
    x = _x(4, 2, 6, 16)
    jm = jbsq.GroupedResidualBSQ(dim=16, groups=4, codebook_size=16,
                                 commitment_loss_weight=0.25)
    pm = bsq.GroupedResidualBSQ(16, 4, 16, commitment_loss_weight=0.25)
    assert [n for n, _ in pm.named_children()] == [f"rvqs_{i}" for i in range(4)]
    aux, _ = _compare(jm, pm, x, seed=5)
    assert aux.shape == (4,)
    out, idx, p_aux = pm(torch.from_numpy(x), training=True)
    assert out.shape == (2, 6, 16) and idx.shape == (4, 2, 6) and p_aux.shape == (4,)
    # the groups are independent: changing group 3's input leaves groups 0-2
    x2 = x.copy()
    x2[..., 12:] = 0.0
    idx2 = pm(torch.from_numpy(x2), training=True)[1]
    assert torch.equal(idx[:3], idx2[:3]) and not torch.equal(idx[3], idx2[3])
