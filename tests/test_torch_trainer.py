"""The port's fine-tuning trainer against the JAX package's, on tiny models.

- ``FTDataset``: the same files, filtering (a too-short clip replaced by the
  md5 rule) and batch order as the JAX dataset on one directory.
- ``Trainer.prepare_batch`` against the JAX trainer's on the same trees (a
  48-wide one-layer Whisper) and the same host generator: the mels with
  their -10 pad, the clean and perturbed content at the same perturbation
  rate, the style, the lengths; first through the fused pair path, then
  through the per-clip feature cache.
- ``TrainerConfig`` has every field of the JAX one, with its defaults.

Two ``Trainer.train`` steps are compared in tests/test_torch_trainer_steps.py.
Tolerance (f32): features 1e-4 absolute (Whisper's and CAMPPlus's sums run
in other orders; the mels agree to 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from seedvc_tpu.train.dataset import FTDataset as JFTDataset
from seedvc_tpu.train.trainer import TrainerConfig as JTrainerConfig
from seedvc_tpu_torch.train.dataset import FTDataset
from seedvc_tpu_torch.train.trainer import TrainerConfig
from torch_port_helpers import trainer_pair, trainer_wav_dir

torch.set_num_threads(1)

SR = 22050
FEAT_TOL = 1e-4


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    return trainer_wav_dir(tmp_path_factory.mktemp("wavs"))


@pytest.fixture(scope="module")
def pair(wav_dir):
    return trainer_pair(wav_dir)


def test_dataset_order_and_filtering_match_jax(wav_dir):
    jds, pds = JFTDataset(wav_dir, SR, 2), FTDataset(wav_dir, SR, 2)
    assert pds.files == jds.files and len(pds) == 5
    for shuffle, epoch in ((False, 0), (True, 0), (True, 1)):
        jb = list(jds.batches(shuffle=shuffle, epoch=epoch))
        pb = list(pds.batches(shuffle=shuffle, epoch=epoch))
        assert len(pb) == len(jb) == 2
        for a, b in zip(pb, jb):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.wave_lengths, b.wave_lengths)
            np.testing.assert_array_equal(a.wave_16k_lengths, b.wave_16k_lengths)
            np.testing.assert_array_equal(a.waves, b.waves)
            np.testing.assert_array_equal(a.waves_16k, b.waves_16k)
            assert (a.wave_lengths > SR * 0.9).all()  # short.wav never appears


def test_prepare_batch_matches_jax(wav_dir, pair):
    jtr, ptr = pair
    batch = next(iter(FTDataset(wav_dir, SR, 2).batches(shuffle=False)))
    for path in ("pair", "cached"):  # the second call hits the feature cache
        jf = jtr.prepare_batch(batch, np.random.default_rng((1234, 3)), step=3)
        pf = ptr.prepare_batch(batch, np.random.default_rng((1234, 3)))
        assert set(pf) == set(jf)
        for k in jf:
            ref = np.asarray(jf[k])
            got = pf[k].numpy()
            assert got.shape == ref.shape, (path, k)
            np.testing.assert_allclose(got, ref, rtol=0, atol=FEAT_TOL, err_msg=f"{path} {k}")
    assert len(ptr._feat_cache) == len(jtr._feat_cache) == 2
    # the perturbed branch really differs from the clean one
    assert np.abs(pf["s_alt"].numpy() - pf["s_ori"].numpy()).max() > 1e-3


def test_trainer_config_has_every_jax_field():
    names = [f.name for f in dataclasses.fields(TrainerConfig)]
    assert names == [f.name for f in dataclasses.fields(JTrainerConfig)]
    assert TrainerConfig() == TrainerConfig(**dataclasses.asdict(JTrainerConfig()))
