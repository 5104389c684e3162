"""The port's v1 ``Trainer`` on a (data, model) mesh of 2 gloo ranks
against the same trainer in one process (random tiny weights from the
trainer's seed, ``tests/test_torch_trainer_cli.py``'s config):

- the data-sharded ``prepare_batch`` (each rank runs the frozen encoders on
  its rows) equals the one-process prep's rows, with the warp perturbation
  and with the OpenVoice converter shuffling the batch's own voices across
  the ranks (the counterpart of ``test_multichip.py:287-329``), 1e-6;
- a checkpoint that a 2-rank run writes (tensor parallel over 2 ranks with
  FSDP, and data parallel over 2 ranks with FSDP, which scatters the
  parameters of 1024 elements or more: the trainer's floor of 65536 is above
  every parameter of this tiny model; the EMA on) restores in a
  1-rank trainer, which then takes the same third step: the loss 1e-6
  relative, parameters and EMA 2e-6 times the largest parameter (see
  tests/test_torch_parallel_step.py);
- an f0-conditioned trainer with the feature cache on: a second
  ``prepare_batch`` of the same clips, every clip now cached, gives the first
  call's features, in one process and on 2 ranks of ``data`` (whose rows
  equal the one-process prep's), 1e-6 (F0, in Hz, 1e-6 relative).
"""

import functools

import numpy as np
import pytest
import torch

import seedvc_tpu.models.openvoice as jov
import seedvc_tpu_torch.models.openvoice as pov
from seedvc_tpu_torch.train.dataset import FTDataset
from seedvc_tpu_torch.train.trainer import Trainer, TrainerConfig
from seedvc_tpu_torch.weights import to_jax_params
from test_torch_trainer_cli import CFG, SR, WHISPER
from torch_parallel_worker import _flat, spawn, start
from torch_port_helpers import ov_tiny_cfg, ov_tree, port_cfg, tiny_train_cfg

torch.set_num_threads(1)

RUNS = [(1, True, False), (2, True, False), (1, False, True)]  # (n_model, fsdp, openvoice)


def _tcfg(**kw):
    return TrainerConfig(**{**dict(run_dir="", batch_size=2, mel_bucket=64, warmup_steps=1,
                                   base_lr=1e-3, weight_ema_decay=0.9, feat_cache_bytes=0,
                                   prefetch=0), **kw})


@pytest.fixture(scope="module")
def wav_batch(tmp_path_factory):
    from seedvc_tpu_torch.apps.audio_io import save_wav

    d = tmp_path_factory.mktemp("pwavs")
    rng = np.random.default_rng(1)
    for i in range(2):
        save_wav(str(d / f"c{i}.wav"), (0.1 * rng.standard_normal(SR + 2500 * i)), SR)
    return next(iter(FTDataset(str(d), SR, 2).batches(shuffle=False)))


def test_two_rank_trainer_matches_one_process(tmp_path, wav_batch, monkeypatch):
    ov_cfg = ov_tiny_cfg(pov)
    tree = ov_tree(ov_tiny_cfg(jov))
    wait = start("trainer", 2, tmp_path, dict(
        cfg=CFG, whisper=WHISPER, tcfg=functools.partial(_tcfg), batch=wav_batch,
        runs=RUNS, ov_cfg=ov_cfg, ov_tree=tree, cwd=str(tmp_path), fsdp_min_elems=1024),
        timeout=150)
    monkeypatch.setattr(pov, "OpenVoiceConfig", lambda: ov_cfg)
    one = {}
    for ov in (False, True):
        tr = Trainer(CFG, _tcfg(), whisper_cfg=WHISPER, device="cpu",
                     **(dict(openvoice_params=tree) if ov else {}))
        one[ov] = tr.prepare_batch(wav_batch, np.random.default_rng(1), step=0)
    got = wait()
    for (n_model, fsdp, ov), out in got.items():
        what = f"n_model {n_model} fsdp {fsdp} openvoice {ov}"
        n_data = 2 // n_model
        for k, ref in one[ov].items():
            if ref.ndim == 0:
                continue
            ranks = out["prep"][k]
            # rank r holds rows r of the batch when data spans both ranks,
            # all of them (twice) when model does
            rows = (np.concatenate(ranks) if n_data == 2 else ranks[0])
            np.testing.assert_allclose(rows, ref.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{what} {k}")
        if not ov:
            assert out["split"], what  # something was split over the mesh
        # the checkpoint of step 2, restored in one process: the same third step
        tr = Trainer(CFG, _tcfg(run_dir=out["run_dir"]), whisper_cfg=WHISPER, device="cpu",
                     **(dict(openvoice_params=tree) if ov else {}))
        assert tr.restore_latest() and tr.state.step == 2
        seed = tr.tcfg.seed
        f = tr.prepare_batch(wav_batch, np.random.default_rng((seed, 2)), step=2)
        tr.state, m = tr.step_fn(tr.state, f, (seed, 2))
        np.testing.assert_allclose(out["losses"][2], float(m["loss"]), rtol=1e-6, err_msg=what)
        ref = _flat(to_jax_params(tr.model))
        ema = _flat(to_jax_params(tr.model, tr.state.ema_params))
        scale = max(float(np.abs(v).max()) for v in ref.values())
        for tree_got, tree_ref in ((out["params"], ref), (out["ema"], ema)):
            assert set(tree_got) == set(tree_ref)
            for n, r in tree_ref.items():
                np.testing.assert_allclose(tree_got[n], r, rtol=0, atol=2e-6 * scale,
                                           err_msg=f"{what} {n}")


F0 = {"f0_condition": True, "n_f0_bins": 64}
RMVPE_SMALL = dict(n_blocks=1, en_de_layers=2, inter_layers=1)


@pytest.mark.parametrize("world", [1, 2])
def test_f0_prep_from_the_feature_cache_equals_the_first(world, tmp_path, wav_batch,
                                                         monkeypatch):
    import seedvc_tpu_torch.models.rmvpe as rmvpe

    cfg = port_cfg(tiny_train_cfg(reg=dict(F0), dit=dict(F0)))
    tcfg = _tcfg(feat_cache_bytes=1 << 20)
    monkeypatch.setattr(rmvpe, "RMVPE_E2E", functools.partial(rmvpe.RMVPE_E2E, **RMVPE_SMALL))
    tr = Trainer(cfg, tcfg, whisper_cfg=WHISPER, device="cpu")
    one = [tr.prepare_batch(wav_batch, np.random.default_rng(1), step=0) for _ in range(2)]
    assert len(tr._feat_cache) == 2 and "f0" in one[0]
    calls = [{k: [v.numpy()] for k, v in c.items() if v.ndim >= 1} for c in one]
    if world == 2:
        out = spawn("f0_cache", 2, tmp_path, dict(cfg=cfg, tcfg=tcfg, whisper=WHISPER,
                                                  batch=wav_batch, rmvpe=RMVPE_SMALL))
        assert out["cached"] == 1  # each rank caches its own row
        calls = out["calls"]
    for k, ref in one[0].items():
        if ref.ndim == 0:
            continue
        first = np.concatenate(calls[0][k])
        # F0 is in Hz: relative to its size
        tol = dict(rtol=1e-6 if k == "f0" else 0, atol=1e-6)
        np.testing.assert_allclose(np.concatenate(calls[1][k]), first, **tol,
                                   err_msg=f"{world} ranks: the cached call's {k}")
        np.testing.assert_allclose(first, ref.numpy(), **tol, err_msg=f"{world} ranks: {k}")
