"""The port's trainer around its steps, on tiny models on the CPU: checkpoints
(``save`` / ``restore_latest``, the EMA, two kept, one a step), the plateau
LR halving, the validation early stop, ``export_serving`` into the port's
``VoiceConverter`` (the tree has the JAX init tree's structure and shapes),
``to_jax_params`` round trips, ``apps.train --device cpu``, and what raises:
no card (the multi-GPU trainer is held in tests/test_torch_parallel_trainer.py);
the OpenVoice perturbation, which raised until it was ported, now builds."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.models.vc import VCModel as JVCModel
from seedvc_tpu_torch.apps.audio_io import save_wav
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.pipelines.convert import VoiceConverter
from seedvc_tpu_torch.train.dataset import FTDataset
from seedvc_tpu_torch.train.trainer import Trainer, TrainerConfig
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params
from torch_port_helpers import ov_tiny_cfg, ov_tree, port_cfg, tiny_train_cfg, vc_tree

torch.set_num_threads(1)

SR = 22050
WHISPER = WhisperEncoderConfig(d_model=48, n_layers=1, n_heads=4, ffn_dim=96)
CFG = port_cfg(tiny_train_cfg())


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(1)
    for i in range(4):
        save_wav(str(d / f"c{i}.wav"), (0.1 * rng.standard_normal(SR + 2500 * i)), SR)
    return str(d)


def _trainer(wav_dir, run_dir="", cfg=CFG, **kw):
    base = dict(data_path=wav_dir, run_dir=run_dir, batch_size=2, epochs=4, max_steps=2,
                log_interval=1, save_interval=1000, mel_bucket=64, warmup_steps=1)
    base.update(kw)
    return Trainer(cfg, TrainerConfig(**base), whisper_cfg=WHISPER, device="cpu")


def test_save_restore_round_trip(wav_dir, tmp_path):
    run = str(tmp_path / "run")
    tr = _trainer(wav_dir, run, save_interval=1, max_steps=3, weight_ema_decay=0.5)
    assert tr.train() == 3  # data_path read by train()
    assert sorted(tr._ckpt_paths()) == [2, 3]  # newest two; step 3 saved once
    tr2 = _trainer(wav_dir, run, weight_ema_decay=0.5)
    assert tr2.restore_latest() and tr2.state.step == 3
    for n, p in tr.state.params.items():
        torch.testing.assert_close(tr2.state.params[n], p, rtol=0, atol=0)
        torch.testing.assert_close(tr2.state.ema_params[n], tr.state.ema_params[n],
                                   rtol=0, atol=0)
    g, g2 = tr.state.opt_state.groups["all"], tr2.state.opt_state.groups["all"]
    assert g2.count == g.count == 3
    for a, b in zip(g.mu + g.nu, g2.mu + g2.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a checkpoint without EMA restored into an EMA run seeds the EMA from the params
    tr3 = _trainer(wav_dir, str(tmp_path / "plain"), save_interval=1, max_steps=1)
    tr3.train()
    tr4 = _trainer(wav_dir, str(tmp_path / "plain"), weight_ema_decay=0.5)
    assert tr4.restore_latest()
    for n, p in tr4.state.params.items():
        torch.testing.assert_close(tr4.state.ema_params[n], p, rtol=0, atol=0)


def test_plateau_halves_lr(wav_dir):
    tr = _trainer(wav_dir, max_steps=3, lr_halve_patience=1)
    tr.best_ema = -1e9  # every log is a plateau
    tr.train()
    assert tr.lr_scale == 0.125 and tr.ema_loss is not None and np.isfinite(tr.ema_loss)


def test_validation_early_stop(wav_dir):
    tr = _trainer(wav_dir, max_steps=100, log_interval=100, validation_interval=1,
                  val_batches=1, early_stop_patience=2)
    ds = FTDataset(wav_dir, SR, 2)
    val = tr.validate(ds)
    assert np.isfinite(val) and tr.validate(ds) == val
    tr.best_val_loss = -1e9
    assert tr.train(ds, val_dataset=ds) == 2 and tr.val_patience == 2


def test_export_serving_converts(wav_dir, tmp_path):
    tr = _trainer(wav_dir, str(tmp_path / "run"), max_steps=1, weight_ema_decay=0.9)
    tr.train()
    path = tr.export_serving(str(tmp_path / "export"))
    with open(path, "rb") as f:
        tree = pickle.load(f)
    ref = vc_tree(tiny_train_cfg().model_params)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
    assert all(a.shape == b.shape and a.dtype == np.float32 for a, b in
               zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)))
    ema = to_jax_params(tr.model, tr.state.ema_params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ema)):
        np.testing.assert_array_equal(a, b)
    # the JAX module takes the tree as its params
    z = jnp.zeros((1, 16, 80))
    JVCModel(tiny_train_cfg().model_params).apply(
        {"params": tree}, jnp.zeros((1, 16, 48)), jnp.zeros((1, 16, 48)), z,
        jnp.full((1,), 16, jnp.int32), jnp.zeros((1, 192)), deterministic=True,
        rngs_dict={k: jax.random.PRNGKey(0) for k in ("prompt", "t", "noise", "drop")})
    voc = dict(upsample_initial_channel=64, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),))
    vc = VoiceConverter(CFG, whisper_cfg=WHISPER, vc_params=tree, prompt_cap_frames=64,
                        context_frames=192, vocoder_cfg=BigVGANConfig(**voc), device="cpu")
    src = np.sin(np.arange(SR) / SR * 2 * np.pi * 180).astype(np.float32) * 0.3
    sr, wave, _ = vc.convert(src, SR, src[: SR // 2], SR, diffusion_steps=2)
    assert sr == SR and np.isfinite(wave).all() and abs(len(wave) - SR) <= 256


@pytest.mark.parametrize("over", [
    {}, {"reg": {"f0_condition": True, "n_f0_bins": 64},
         "dit": {"f0_condition": True, "n_f0_bins": 64}},
    {"reg": {"vector_quantize": True, "content_codebook_size": 32}},
    {"dit": {"final_layer_type": "mlp", "long_skip_connection": False}}])
def test_to_jax_params_round_trip(over):
    jcfg = tiny_train_cfg(**{k: dict(v) for k, v in over.items()})
    ref = vc_tree(jcfg.model_params, seed=7)
    m = load_jax_params(VCModel(port_cfg(jcfg.model_params)), ref)
    tree = to_jax_params(m)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    m2 = load_jax_params(VCModel(port_cfg(jcfg.model_params)), tree)
    for (n, a), (_, b) in zip(m.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n


def _patch_cli(monkeypatch):
    from seedvc_tpu_torch.core import config as config_mod
    from seedvc_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(config_mod, "get_preset", lambda _name: CFG)
    real = trainer_mod.Trainer
    monkeypatch.setattr(trainer_mod, "Trainer",
                        lambda cfg, tcfg, **kw: real(cfg, dataclasses.replace(
                            tcfg, mel_bucket=64, warmup_steps=1), whisper_cfg=WHISPER, **kw))


def test_train_cli_cpu_run_resumes_and_exports(wav_dir, tmp_path, monkeypatch):
    from seedvc_tpu_torch.apps import train as train_app

    _patch_cli(monkeypatch)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset-dir", wav_dir, "--device", "cpu", "--batch-size", "2",
            "--save-interval", "2", "--log-interval", "1", "--export-dir", str(tmp_path / "x")]
    tr = train_app.main(argv + ["--max-steps", "2"])
    assert tr.state.step == 2 and os.path.exists(tmp_path / "runs/run1/ckpt_00000002.pt")
    tr = train_app.main(argv + ["--max-steps", "3"])
    assert [h["step"] for h in tr.history] == [3]  # resumed at step 2
    with open(tmp_path / "x/vc.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"cfm", "length_regulator"}


def test_what_raises(wav_dir, monkeypatch):
    from seedvc_tpu_torch.apps import train as train_app

    tc = TrainerConfig(data_path=wav_dir, run_dir="")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(CFG, tc, whisper_cfg=WHISPER)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_app.main(["--dataset-dir", wav_dir, "--max-steps", "1"])
    # the OpenVoice perturbation (tiny converter) builds and prepares a batch
    import seedvc_tpu.models.openvoice as jov
    import seedvc_tpu_torch.models.openvoice as pov

    pcfg = ov_tiny_cfg(pov)
    monkeypatch.setattr(pov, "OpenVoiceConfig", lambda: pcfg)
    tr = Trainer(CFG, dataclasses.replace(tc, mel_bucket=64), whisper_cfg=WHISPER,
                 openvoice_params=ov_tree(ov_tiny_cfg(jov)),
                 se_db=np.ones((4, 12), np.float32), device="cpu")
    batch = next(iter(FTDataset(wav_dir, SR, 2).batches(shuffle=False)))
    feats = tr.prepare_batch(batch, np.random.default_rng(0))
    assert feats["s_alt"].shape == feats["s_ori"].shape
    assert torch.isfinite(feats["s_alt"]).all()
    assert (feats["s_alt"] - feats["s_ori"]).abs().max() > 1e-3
