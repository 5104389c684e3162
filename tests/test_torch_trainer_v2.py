"""The port's v2 trainer against the JAX package's, on tiny models
(tests/test_trainer_v2.py::tiny_v2cfg) and the same frozen trees:

- ``prepare_batch``: the mels with their -10 pad in 64-frame buckets, the
  wide indices (zeroed past each clip's token count), the duration-reduced
  narrow condition, the lengths and maxima, the CAMPPlus style, and the
  static sizes (``mel_T``, ``ar_C``, ``ar_X``, ``tok_T``);
- ``TrainerV2Config`` has every field of the JAX one, with its defaults;
- the frozen trees come back from the port's modules (``to_jax_params``);
- a clip that ends within 320 samples of its 5 s bucket has one token more
  than the SSL frames: the port holds the regulator's ``x_lens`` to the
  frames and its loss stays finite (the JAX trainer's gather reads past
  them there).

The steps are held in tests/test_torch_trainer_v2_steps.py and
test_torch_trainer_v2_distill.py; the loop, freezing, validation and
checkpoints in test_torch_trainer_v2_cli.py. Tolerance (f32): features
1e-5 absolute (mels, style); indices and lengths equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from seedvc_tpu.train.trainer_v2 import TrainerV2 as JTrainerV2
from seedvc_tpu.train.trainer_v2 import TrainerV2Config as JTrainerV2Config
from seedvc_tpu_torch.train.dataset import Batch
from seedvc_tpu_torch.train.trainer_v2 import TrainerV2, TrainerV2Config
from seedvc_tpu_torch.weights import to_jax_params
from test_trainer_v2 import tiny_v2cfg
from torch_port_helpers import v2_batch, v2_port_cfg, v2_trees

torch.set_num_threads(1)

FEAT_TOL = 1e-5
TCFG = dict(batch_size=2, mel_bucket=64, token_bucket=32)


@pytest.fixture(scope="module")
def pair():
    jcfg = tiny_v2cfg()
    frozen, _ = v2_trees(jcfg)
    jtr = JTrainerV2(jcfg, JTrainerV2Config(**TCFG), frozen_params=frozen, n_model=4)
    ptr = TrainerV2(v2_port_cfg(jcfg), TrainerV2Config(**TCFG), frozen_params=frozen,
                    device="cpu")
    ptr.frozen_trees = frozen
    return jtr, ptr


def test_prepare_batch_matches_jax(pair):
    jtr, ptr = pair
    batch = v2_batch(seed=3)
    jf, jdims = jtr.prepare_batch(batch)
    pf, pdims = ptr.prepare_batch(batch)
    assert pdims == jdims and set(pf) == set(jf)
    for k in jf:
        ref, got = np.asarray(jf[k]), pf[k].numpy()
        assert got.shape == ref.shape, k
        if k in ("mels", "style"):
            np.testing.assert_allclose(got, ref, rtol=0, atol=FEAT_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    # the tokens carry information: the narrow condition was reduced, and the
    # wide indices are zero past each clip's count and not before
    assert (pf["ar_cond_lens"].numpy() <= pf["token_lens"].numpy()).all()
    assert len(np.unique(pf["wide_idx"].numpy())) > 4
    assert not pf["wide_idx"][1, int(pf["token_lens"][1]):].any()


def test_frozen_trees_round_trip(pair):
    """``load_jax_params`` then ``to_jax_params`` gives each frozen tree back
    (the trainable ones are held against JAX's in the step tests)."""
    import jax

    _, ptr = pair
    for name, tree in ptr.frozen_trees.items():
        got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(getattr(ptr, name))))
        ref = jax.tree_util.tree_leaves_with_path(tree)
        assert len(got) == len(ref), name
        for path, r in ref:
            np.testing.assert_array_equal(got[path], r, err_msg=f"{name} {path}")


def test_trainer_v2_config_has_every_jax_field():
    fields = [(f.name, f.default) for f in dataclasses.fields(TrainerV2Config)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JTrainerV2Config)]


def test_token_count_past_the_ssl_frames_stays_finite(pair):
    _, ptr = pair
    rng = np.random.default_rng(4)
    n16 = 80000  # exactly one 5 s bucket: 250 tokens, 249 SSL frames
    w16 = (0.1 * rng.standard_normal((2, n16))).astype(np.float32)
    n = n16 * 22050 // 16000
    waves = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    batch = Batch(waves, w16, np.array([n, n - 3000], np.int32),
                  np.array([n16, n16 - 5000], np.int32))
    feats, dims = ptr.prepare_batch(batch)
    assert int(feats["token_lens"].max()) == 250 and dims["ar_X"] == 249
    assert int(feats["tok_max"]) == 249
    metrics = ptr.train_step(batch)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
