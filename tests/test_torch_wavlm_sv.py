"""The port's WavLM-SV x-vector extractor against the JAX module, on the CPU.

At ``tests/test_wavlm_sv.py::jax_cfg`` (48 wide, 2 layers, 40 buckets), on
one random flax tree with non-trivial layer weights and relative-position
gates (set as that file sets them on the HF model):

- the relative-position buckets equal JAX's bit for bit;
- the forward equals JAX's on unpadded waves, and with ``lengths`` that mark
  every sample valid;
- a zero-padded batch with ``lengths`` equals each clip's unpadded forward.
  The JAX module's padded forward does not: its conv-0 GroupNorm takes
  statistics over the padding (ROADMAP queue 3); the port's takes them over
  the true frames.

Tolerance (f32): embeddings 1e-4 relative L2 against JAX (the attention,
layer sum and pooling in other orders); padded against unpadded 1e-5
absolute (the same arithmetic up to sums over exact zeros).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.models import wavlm_sv as jw
from seedvc_tpu_torch.models import wavlm_sv as pw
from seedvc_tpu_torch.weights import load_jax_params
from test_wavlm_sv import jax_cfg
from torch_port_helpers import jax_apply, jax_init

torch.set_num_threads(1)

REL_TOL, PAD_TOL = 1e-4, 1e-5


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_cfg()
    jm = jw.WavLMSV(jcfg)
    tree = jax_init(jm, jnp.zeros((1, 8000)), seed=3)
    tree["layer_weights"] = np.array([0.2, 1.0, -0.5], np.float32)
    rng = np.random.default_rng(4)
    for i in range(jcfg.n_layers):
        att = tree[f"layers_{i}"]["attention"]
        att["gru_rel_pos_const"] = rng.uniform(0.5, 1.5, (1, 4, 1, 1)).astype(np.float32)
    pm = load_jax_params(pw.WavLMSV(pw.WavLMSVConfig(**dataclasses.asdict(jcfg))), tree).eval()
    return jm, pm, tree


@pytest.mark.parametrize("T,nb,md", [(37, 40, 80), (300, 40, 80), (260, 320, 800),
                                     (1499, 320, 800)])
def test_relative_position_buckets_equal_jax(T, nb, md):
    got = pw.relative_position_buckets(T, nb, md)
    np.testing.assert_array_equal(got, jw.relative_position_buckets(T, nb, md))
    assert got.dtype == np.int64


def test_forward_matches_jax(models):
    jm, pm, tree = models
    wave = (np.random.default_rng(0).standard_normal((2, 12000)) * 0.1).astype(np.float32)
    for normalize in (False, True):
        ref = np.asarray(jax_apply(jm, tree, jnp.asarray(wave), normalize=normalize))
        with torch.no_grad():
            got = pm(torch.from_numpy(wave), normalize=normalize).numpy()
        assert got.shape == ref.shape == (2, 20)
        assert rel_l2(got, ref) < REL_TOL, normalize
    # lengths that mark every sample valid take the masked path on both sides
    lens = np.full(2, 12000, np.int32)
    ref = np.asarray(jax_apply(jm, tree, jnp.asarray(wave), lengths=jnp.asarray(lens)))
    with torch.no_grad():
        got = pm(torch.from_numpy(wave), lengths=torch.from_numpy(lens)).numpy()
    assert rel_l2(got, ref) < REL_TOL


def test_padded_bucket_equals_unpadded(models):
    _, pm, _ = models
    rng = np.random.default_rng(1)
    lens, T = [9000, 12000], 16000
    wave = np.zeros((2, T), np.float32)
    for i, n in enumerate(lens):
        wave[i, :n] = rng.standard_normal(n) * 0.1
    with torch.no_grad():
        padded = pm(torch.from_numpy(wave), lengths=torch.tensor(lens)).numpy()
        for i, n in enumerate(lens):
            solo = pm(torch.from_numpy(wave[i:i + 1, :n])).numpy()
            np.testing.assert_allclose(padded[i:i + 1], solo, rtol=0, atol=PAD_TOL)
