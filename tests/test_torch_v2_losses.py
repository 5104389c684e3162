"""The v2 trainer's losses in the port against the JAX package's, on the
same random weights, inputs and JAX's draws, value and gradients
(``jax.value_and_grad`` against ``backward``):

- ``cfm_v2_loss`` (l1 and l2) through a tiny ``DiTV2`` with ``x_lens`` and
  prompt lengths, the prompt and content dropped for one case: the loss and
  the gradient of every DiT parameter and of the condition ``mu``; t and the
  noise are the ones JAX draws from its keys;
- ``ar_loss`` through a tiny ``ARTransformer`` over a packed batch with
  uneven condition and target lengths (one target empty): the loss and the
  gradient of every AR parameter (``sep_token_emb`` included) and of the
  condition embeddings; the AR's attention runs in f32 under autograd.

Tolerance (f32): losses 1e-5 relative, gradients 1e-5 relative to the
largest of their tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.models import cfm_v2 as jcfm
from seedvc_tpu.models.ar import ARConfig as JARConfig
from seedvc_tpu.models.ar import ARTransformer as JAR
from seedvc_tpu.models.ar_train import ar_loss as j_ar_loss
from seedvc_tpu.models.dit_v2 import DiTV2 as JDiTV2
from seedvc_tpu.models.dit_v2 import DiTV2Config as JDiTV2Config
from seedvc_tpu_torch.models import ar as par
from seedvc_tpu_torch.models import cfm_v2
from seedvc_tpu_torch.models.ar_train import ar_loss
from seedvc_tpu_torch.models.dit_v2 import DiTV2, DiTV2Config
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import jax_init

torch.set_num_threads(1)
RTOL = 1e-5

DIT = dict(hidden_dim=64, depth=2, num_heads=4, in_channels=16, content_dim=32,
           style_encoder_dim=24)
AR = dict(dim=32, n_layer=2, n_head=4, n_local_heads=2, head_dim=8, intermediate_size=64,
          vocab_size=33, max_seq_len=128)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check_grads(module, grads_t: dict, j_grads):
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(module, grads_t)))
    ref = jax.tree_util.tree_map(np.asarray, j_grads)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(ref))
    assert scale > 0
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(got) == len(leaves)
    for path, r in leaves:
        np.testing.assert_allclose(got[path], r, atol=RTOL * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("loss_type,drop", [("l1", False), ("l2", False), ("l1", True)])
def test_cfm_v2_loss_matches_jax(loss_type, drop):
    B, T, C = 2, 40, DIT["in_channels"]
    jm = JDiTV2(JDiTV2Config(**DIT))
    x1, mu = _x(1, B, T, C) - 3.0, _x(2, B, T, DIT["content_dim"])
    style = _x(3, B, DIT["style_encoder_dim"])
    x_lens = np.array([T, 29], np.int32)
    prompt_lens = np.array([11, 0], np.int32)
    pdv = np.full((B,), float(drop), np.float32)
    cdv = pdv.copy()
    params = jax_init(jm, x1, x1, x_lens, np.zeros(B, np.float32), style, mu, seed=4)
    k_t, k_noise = jax.random.split(jax.random.PRNGKey(7))

    def jloss(p, m):
        def est(x, px, lens, t, s, mm):
            return jm.apply({"params": p}, x, px, lens, t, s, mm, prompt_drop=pdv,
                            content_drop=cdv)
        return jcfm.cfm_v2_loss(est, x1, x_lens, prompt_lens, m, style, rng_t=k_t,
                                rng_noise=k_noise, loss_type=loss_type)

    j_val, (j_gp, j_gmu) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, mu)
    t = torch.from_numpy(np.array(jax.random.uniform(k_t, (B,), dtype=jnp.float32)))
    noise = torch.from_numpy(np.array(jax.random.normal(k_noise, (B, T, C))))

    pm = load_jax_params(DiTV2(DiTV2Config(**DIT)), params)
    mu_t = torch.from_numpy(mu).requires_grad_()
    pdt, cdt = torch.from_numpy(pdv), torch.from_numpy(cdv)

    def est(x, px, lens, tt, s, m):
        return pm(x, px, lens, tt, s, m, prompt_drop=pdt, content_drop=cdt)

    val = cfm_v2.cfm_v2_loss(est, torch.from_numpy(x1), torch.from_numpy(x_lens),
                             torch.from_numpy(prompt_lens), mu_t, torch.from_numpy(style),
                             t=t, noise=noise, loss_type=loss_type)
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=RTOL)
    _check_grads(pm, {n: q.grad for n, q in pm.named_parameters()}, j_gp)
    np.testing.assert_allclose(mu_t.grad.numpy(), np.asarray(j_gmu),
                               atol=RTOL * float(np.abs(j_gmu).max()), rtol=0)
    if drop:  # the content was dropped: mu gets no gradient
        assert float(np.abs(j_gmu).max()) == 0.0


def test_cfm_v2_loss_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="loss_type"):
        cfm_v2.cfm_v2_loss(None, torch.zeros(1, 2, 3), None, None, None, None,
                           t=torch.zeros(1), noise=torch.zeros(1, 2, 3), loss_type="huber")


def test_ar_loss_matches_jax(monkeypatch):
    cfg = JARConfig(**AR)
    jm = JAR(cfg)
    B, C_max, X_max = 3, 9, 7
    params = jax_init(jm, np.zeros((1, 4), np.int32), np.arange(4)[None],
                      np.tril(np.ones((4, 4), bool))[None, None], seed=5, method=jm.init_all)
    cond_emb = _x(6, B, C_max, AR["dim"])
    targets = np.random.default_rng(7).integers(0, AR["vocab_size"] - 1, (B, X_max))
    cond_lens, target_lens = np.array([9, 4, 1]), np.array([7, 3, 0])

    def jloss(p, c):
        return j_ar_loss(jm, {"params": p}, c, cond_lens, targets, target_lens)

    j_val, (j_gp, j_gc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, cond_emb)

    calls = []
    real_bmm = par._bmm_f32

    def spy(a, b):
        calls.append((a.dtype, b.dtype, a.requires_grad))
        return real_bmm(a, b)

    monkeypatch.setattr(par, "_bmm_f32", spy)
    pm = load_jax_params(par.ARTransformer(par.ARConfig(**AR)), params)
    c = torch.from_numpy(cond_emb).requires_grad_()
    val = ar_loss(pm, c, torch.from_numpy(cond_lens), torch.from_numpy(targets),
                  torch.from_numpy(target_lens))
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=RTOL)
    grads = {n: q.grad for n, q in pm.named_parameters()}
    assert grads["sep_token_emb"] is not None
    _check_grads(pm, grads, j_gp)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(j_gc),
                               atol=RTOL * float(np.abs(j_gc).max()), rtol=0)
    # autograd went through the AR's f32 logits product, a layer each
    assert calls == [(torch.float32, torch.float32, True)] * AR["n_layer"]
