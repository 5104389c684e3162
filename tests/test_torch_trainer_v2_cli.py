"""The port's v2 trainer around its steps, on tiny models on the CPU (its own
random weights from the seed): freezing (``train_ar=False`` keeps the AR and
its regulator bit for bit and gives them no moments; ``train_cfm=False``
the same for the DiT and its regulator, whose attention then runs no
time), the loop's validation and patience early stop, checkpoints
(``save`` / ``restore_latest``, newest two kept, one save a step),
``apps.train_v2 --device cpu`` with a resume, ``--checkpoint-dir`` picking
up the frozen encoders' pickles, and what raises: no card (the multi-GPU
trainer is held in tests/test_torch_parallel_trainer.py)."""

import os
import pickle

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.apps import train_v2 as train_v2_app
from seedvc_tpu_torch.apps.audio_io import save_wav
from seedvc_tpu_torch.nn import layers
from seedvc_tpu_torch.train.dataset import FTDataset
from seedvc_tpu_torch.train.trainer_v2 import TrainerV2, TrainerV2Config
from seedvc_tpu_torch.weights import to_jax_params
from test_trainer_v2 import tiny_v2cfg
from torch_port_helpers import v2_batch, v2_port_cfg

torch.set_num_threads(1)

SR = 22050
CFG = v2_port_cfg(tiny_v2cfg())
TCFG = dict(batch_size=2, mel_bucket=64, token_bucket=32, warmup_steps=1, base_lr=1e-3,
            log_interval=1)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(1)
    for i in range(4):
        t = np.arange(int((1.2 + 0.25 * i) * SR)) / SR
        wave = 0.3 * np.sin(2 * np.pi * (140 + 30 * i) * t) + 0.05 * rng.standard_normal(t.size)
        save_wav(str(d / f"c{i}.wav"), wave.astype(np.float32), SR)
    return str(d)


def _trainer(**over):
    return TrainerV2(CFG, TrainerV2Config(**{**TCFG, **over}), device="cpu")


@pytest.mark.parametrize("frozen,trained", [("ar", "cfm"), ("cfm", "ar")])
def test_freezing_keeps_the_frozen_branch(monkeypatch, frozen, trained):
    calls = []
    real = layers.dit_attention_fused_diff
    monkeypatch.setattr(layers, "dit_attention_fused_diff",
                        lambda *a: calls.append(1) or real(*a))
    tr = _trainer(**{f"train_{frozen}": False})
    modules = {"cfm": ("dit", "cfm_reg"), "ar": ("ar", "ar_reg")}
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    feats, dims = tr.prepare_batch(v2_batch())
    for i in range(2):
        metrics = tr._device_step(feats, dims, (1234, i))
        assert f"loss_{trained}" in metrics and f"loss_{frozen}" not in metrics
    for n, p in tr.model.named_parameters():
        same = torch.equal(p, before[n])
        assert same == n.startswith(modules[frozen]), n
    groups = tr.state.opt_state.groups
    assert groups[frozen].mu == [] and groups[frozen].nu == [] and groups[frozen].count == 0
    assert groups[trained].count == 2
    # the DiT's attention runs only when the CFM branch trains: a layer a step
    assert len(calls) == (2 * CFG.dit.depth if trained == "cfm" else 0)


def test_validate_and_early_stop(wav_dir):
    tr = _trainer(max_steps=100, epochs=50, log_interval=100, save_interval=1000,
                  validation_interval=1, val_batches=1, early_stop_patience=2)
    ds = FTDataset(wav_dir, SR, 2)
    val = tr.validate(ds)
    assert np.isfinite(val) and tr.validate(ds) == val  # deterministic
    tr.best_val_loss = -1e9  # a permanent plateau
    assert tr.train(ds, val_dataset=ds) == 2
    assert tr.patience_counter == 2
    assert [h["step"] for h in tr.history] == [1, 2]


def test_save_restore_round_trip(wav_dir, tmp_path):
    run = str(tmp_path / "run")
    tr = _trainer(run_dir=run, save_interval=1, max_steps=3, train_ar=False)
    assert tr.train(FTDataset(wav_dir, SR, 2)) == 3
    assert tr.latest_step() == 3
    files = sorted(os.listdir(run))
    assert files == ["ckpt_00000002.pt", "ckpt_00000003.pt"]  # newest two, step 3 once
    tr.save(3)  # the same step again writes nothing
    assert sorted(os.listdir(run)) == files
    tr2 = _trainer(run_dir=run, train_ar=False)
    assert tr2.restore_latest() and tr2.state.step == 3
    for n, p in tr.state.params.items():
        assert torch.equal(tr2.state.params[n], p), n
    for g in ("cfm", "ar"):
        a, b = tr.state.opt_state.groups[g], tr2.state.opt_state.groups[g]
        assert a.count == b.count and len(a.mu) == len(b.mu)
        for x, y in zip(a.mu + a.nu, b.mu + b.nu):
            assert torch.equal(x, y)
    assert not _trainer(run_dir=str(tmp_path / "empty")).restore_latest()


def test_a_state_built_without_a_layout_steps_and_saves(tmp_path):
    """A caller may build the state itself (as ``chip_smoke.py`` phase 10b
    does for a fresh optimizer): without a ``layout`` it is ``WHOLE``, every
    tensor whole on one process, and the step, the checkpoint and the
    restore take it."""
    from seedvc_tpu_torch.parallel.sharding import WHOLE
    from seedvc_tpu_torch.train.trainer_v2 import V2TrainState

    tr = _trainer(run_dir=str(tmp_path / "run"))
    params = tr.state.params
    tr.state = V2TrainState(params, tr.optimizer.init(params), 0)
    assert tr.state.layout is WHOLE and WHOLE.mesh.size_total == 1 and not WHOLE.entries
    feats, dims = tr.prepare_batch(v2_batch())
    assert np.isfinite(float(tr._device_step(feats, dims, (0, 0))["loss"]))
    assert tr.state.layout is WHOLE
    tr.save(1)
    tr2 = _trainer(run_dir=str(tmp_path / "run"))
    tr2.state = V2TrainState(tr2.state.params, tr2.state.opt_state, tr2.state.step)
    assert tr2.restore_latest() and tr2.state.step == 1
    for n, p in tr.state.params.items():
        assert torch.equal(tr2.state.params[n], p), n


def test_train_v2_cli_cpu_run_resumes(wav_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # the frozen encoders from pickles: the SSL's tree of another trainer
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    donor = TrainerV2(CFG, TrainerV2Config(seed=7), device="cpu")
    with open(ckpt / "ssl.pkl", "wb") as f:
        pickle.dump(to_jax_params(donor.ssl), f)
    argv = ["--dataset-dir", wav_dir, "--device", "cpu", "--batch-size", "2",
            "--save-interval", "2", "--log-interval", "1", "--warmup-steps", "1",
            "--checkpoint-dir", str(ckpt)]
    tr = train_v2_app.main(argv + ["--max-steps", "2"], vcfg=CFG)
    assert tr.state.step == 2 and os.path.exists(tmp_path / "runs/v2run/ckpt_00000002.pt")
    for (n, a), (_, b) in zip(tr.ssl.named_parameters(), donor.ssl.named_parameters()):
        assert torch.equal(a, b), n
    tr = train_v2_app.main(argv + ["--max-steps", "3", "--train-ar", "false"], vcfg=CFG)
    assert [h["step"] for h in tr.history] == [3]  # resumed at step 2
    assert all(np.isfinite(float(h["loss"])) for h in tr.history)


def test_what_raises(wav_dir, monkeypatch):
    tc = TrainerV2Config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainerV2(CFG, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_v2_app.main(["--dataset-dir", wav_dir], vcfg=CFG)
