"""The port's v1 trainer with the OpenVoice timbre perturbation against the
JAX trainer's, on tiny models.

Both trainers build ``ToneColorConverter(OpenVoiceConfig())``; the tests
patch ``OpenVoiceConfig`` in both packages' ``models.openvoice`` to the tiny
config of tests/test_openvoice.py (the JAX trainer imports it when it is
built and when it perturbs), and give both the same random flax tree, whose
couplings' ``post`` is drawn (not zero).

- ``Trainer.prepare_batch`` with a ``se_db`` bank and without (the batch's
  own embeddings shuffled), through the pair path and the feature cache: the
  clean and perturbed content, style, mels and lengths, from one
  ``default_rng((seed, step))`` on both sides, which must take the same
  draws (the generators agree afterwards).
- One ``Trainer.train`` step with the bank, JAX's draws replayed.

Tolerance (f32): features 1e-4 absolute, as tests/test_torch_trainer.py; the
step's parameters to 1e-5 times the largest and its loss to 1e-4 relative,
as tests/test_torch_trainer_steps.py.
"""

import jax
import numpy as np
import pytest
import torch

import seedvc_tpu.models.openvoice as jov
import seedvc_tpu_torch.models.openvoice as pov
from seedvc_tpu.train.dataset import FTDataset as JFTDataset
from seedvc_tpu_torch.train.dataset import FTDataset
from seedvc_tpu_torch.weights import to_jax_params
from torch_port_helpers import ov_tiny_cfg, ov_tree, trainer_pair, trainer_wav_dir

torch.set_num_threads(1)

SR = 22050
FEAT_TOL = 1e-4


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    return trainer_wav_dir(tmp_path_factory.mktemp("wavs"))


@pytest.fixture(scope="module")
def pair(wav_dir):
    with pytest.MonkeyPatch.context() as mp:
        jcfg, pcfg = ov_tiny_cfg(jov), ov_tiny_cfg(pov)
        mp.setattr(jov, "OpenVoiceConfig", lambda: jcfg)
        mp.setattr(pov, "OpenVoiceConfig", lambda: pcfg)
        se_db = np.random.default_rng(5).standard_normal((3, 12)).astype(np.float32)
        jtr, ptr = trainer_pair(wav_dir, openvoice_params=ov_tree(jcfg, seed=4), se_db=se_db)
        assert ptr.openvoice.cfg.inter_channels == 8
        yield jtr, ptr, se_db


def compare(jf, pf, what):
    assert set(pf) == set(jf), what
    for k in jf:
        ref, got = np.asarray(jf[k]), pf[k].numpy()
        assert got.shape == ref.shape, (what, k)
        np.testing.assert_allclose(got, ref, rtol=0, atol=FEAT_TOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("bank", [True, False])
def test_prepare_batch_matches_jax(wav_dir, pair, bank):
    jtr, ptr, se_db = pair
    jtr.se_db = ptr.se_db = se_db if bank else None
    for tr in (jtr, ptr):
        tr._feat_cache.clear()
        tr._feat_cache_used = 0
    batch = next(iter(FTDataset(wav_dir, SR, 2).batches(shuffle=False)))
    for path in ("pair", "cached"):  # the second call hits the feature cache
        jrng, prng = np.random.default_rng((1234, 3)), np.random.default_rng((1234, 3))
        jf = jtr.prepare_batch(batch, jrng, step=3)
        pf = ptr.prepare_batch(batch, prng, step=3)
        compare(jf, pf, f"bank={bank} {path}")
        assert jrng.random() == prng.random()  # the same draws were taken
        # the perturbation acts
        assert np.abs(pf["s_alt"].numpy() - pf["s_ori"].numpy()).max() > 1e-3
    assert len(ptr._feat_cache) == len(jtr._feat_cache) == 2


def test_se_db_rows_follow_the_step(pair):
    """The bank's rows (step * B + b) % len(se_db): steps 1 and 4 pick the
    same rows of a 3-row bank, step 2 others; the noise comes from the
    generator."""
    _, ptr, se_db = pair
    ptr.se_db = se_db
    waves = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4096))
                             .astype(np.float32) * 0.1)

    def run(step):
        with torch.no_grad():
            return ptr._perturb_openvoice(waves, np.random.default_rng(0), step)

    assert torch.equal(run(1), run(4))
    assert (run(1) - run(2)).abs().max() > 1e-4


def test_one_train_step_matches_jax(wav_dir, pair):
    jtr, ptr, se_db = pair
    jtr.se_db = ptr.se_db = se_db
    jtr.tcfg.max_steps = ptr.tcfg.max_steps = 1
    assert jtr.train(JFTDataset(wav_dir, SR, 2)) == 1
    assert ptr.train(FTDataset(wav_dir, SR, 2)) == 1
    np.testing.assert_allclose(ptr.ema_loss, jtr.ema_loss, rtol=1e-4)
    ref = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(ref))
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(ptr.model)))
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))
