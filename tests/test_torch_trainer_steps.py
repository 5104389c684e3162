"""Two ``Trainer.train`` steps of the port against two of the JAX trainer,
from the same trees, on the same directory, with JAX's draws (the port's
``draws_fn`` replays the JAX loop's key chain, ``jax_chain_draws``) and the
same host generator for the perturbation rates.

Tolerance (f32): the parameters after two steps to 1e-5 times the largest
one and the loss EMA to 1e-4 relative, as in tests/test_torch_train_step.py.
"""

import jax
import numpy as np
import pytest
import torch

from seedvc_tpu.train.dataset import FTDataset as JFTDataset
from seedvc_tpu_torch.train.dataset import FTDataset
from seedvc_tpu_torch.weights import to_jax_params
from torch_port_helpers import trainer_pair, trainer_wav_dir

torch.set_num_threads(1)

SR = 22050


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    return trainer_wav_dir(tmp_path_factory.mktemp("wavs"))


def test_two_train_steps_match_jax(wav_dir, monkeypatch):
    from seedvc_tpu_torch.ops import attention

    backward_calls = []
    twin_bwd = attention.dit_attention_fused_bwd
    monkeypatch.setattr(attention, "dit_attention_fused_bwd",
                        lambda *a: backward_calls.append(1) or twin_bwd(*a))
    jtr, ptr = trainer_pair(wav_dir)
    ds = FTDataset(wav_dir, SR, 2)
    assert jtr.train(JFTDataset(wav_dir, SR, 2)) == 2
    assert ptr.train(ds) == 2
    assert ptr.state.step == int(jtr.state.step) == 2
    np.testing.assert_allclose(ptr.ema_loss, jtr.ema_loss, rtol=1e-4)
    ref = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(ref))
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(ptr.model)))
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    # every DiT attention's backward went through the K1 Function, a layer a step
    assert len(backward_calls) == 2 * ptr.cfg.model_params.DiT.depth == 4
    assert [h["step"] for h in ptr.history] == [1, 2]
