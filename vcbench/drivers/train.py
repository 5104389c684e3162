"""Fine-tuning: ``Trainer.train`` on a seeded dataset, the trainer's own
defaults (batch 2, f32, mel bucket 128, two batches prepared ahead on the
worker thread, the feature cache on), as the reference ``train.py`` recipe.

Set-up writes the dataset (seeded speech-like clips) into a directory under
``TMPDIR``, builds the trainer, fills its weights from the seed and runs one
epoch, which fills the feature cache and meets every mel bucket. The window
then puts the trainer back at step 0 (the seeded weights, a fresh optimizer
state; the cache and the built kernels stay), runs epochs for ``--seconds``
and closes when the last step sent has finished (a device synchronise at
both edges), so it holds whole steps, every one of them a feature-cache hit.
``train_frames_per_s``: the real (unpadded) mel frames of the window's
batches over its seconds. With ``--trace 1`` the first ``trace.steps`` steps
run under the profiler before the window opens, and the window's steps each
end in a device synchronise (``step_ms``).

The check follows the window's first three steps: the frozen reference
prepares their batches again from the raw waves (no cache) and takes the
same three steps from the same weights and draws. Compared, each by its
worst case: the steps' losses, the first gradient as the optimizer got it
(the program's from its first moment after one step, m / (1 - b1)), and each
leaf's change after three steps; leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the last two.
"""

from __future__ import annotations

import copy
import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from vcbench import control, traffic as T, weights
from vcbench.audio import speech_like
from vcbench.trace import SubWindow


def _draws_fn(seed: int, draws_cls, class_dropout_prob: float):
    """A step's draws from the step key ``(seed, step)`` alone (the
    benchmark's, handed to the program and to the reference)."""
    def draws_fn(key, shape, device):
        B, Tn, C = shape
        g = torch.Generator(device=device)
        g.manual_seed((int(key[0]) * 1_000_003 + 31 * int(key[1]) + 5) % (2 ** 63))

        def rand(*s):
            return torch.rand(s, generator=g, device=device)
        prompt_frac, zero_u, t = rand(B), rand(B), rand(B)
        noise = torch.randn((B, Tn, C), generator=g, device=device)
        drop = (rand(B) < class_dropout_prob).to(torch.float32) if class_dropout_prob > 0 \
            else None
        return draws_cls(prompt_frac, zero_u < 0.1, t, noise, drop)
    return draws_fn


def write_dataset(tr: dict, seed: int, root: str) -> list[float]:
    """The traffic's clips as 16-bit wav files; returns their seconds."""
    from scipy.io import wavfile
    ds = tr["dataset"]
    n, sr = int(ds["clips"]), int(ds["sample_rate"])
    secs = T.cycle_values(ds["seconds"], n)
    for i, s in enumerate(secs):
        x = speech_like(s, sr, T.rng(seed, 5, i))
        wavfile.write(os.path.join(root, f"clip_{i:03d}.wav"), sr,
                      (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return secs


class Feed:
    """The dataset's batches of one epoch, recorded as they are handed out,
    until ``limit`` batches or the ``deadline`` (perf_counter) has passed."""

    def __init__(self, dataset, epoch: int, log: list, limit=None, deadline=None):
        self.dataset, self.epoch, self.log = dataset, epoch, log
        self.limit, self.deadline = limit, deadline

    def batches(self, shuffle: bool = True, epoch: int = 0):
        for i, b in enumerate(self.dataset.batches(shuffle, self.epoch)):
            if self.limit is not None and i >= self.limit:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            self.log.append(b)
            yield b


def trainer_config(tr: dict, seed: int):
    from seedvc_tpu_torch.train.trainer import TrainerConfig
    return TrainerConfig(data_path="", run_dir="", epochs=1, max_steps=10 ** 9, seed=seed,
                         **tr.get("trainer", {}))


def setup(run, builder):
    from seedvc_tpu_torch.models.vc import TrainDraws
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.trainer import Trainer
    tr, dev, cfg = run.traffic, run.device, run.config
    data_dir = tempfile.mkdtemp(prefix="vcbench-data-", dir=os.environ.get("TMPDIR"))
    secs = write_dataset(tr, run.seed, data_dir)
    seed_cfg, enc, _ = builder.configs("seedvc_tpu_torch", cfg)
    tcfg = trainer_config(tr, run.seed)
    trainer = Trainer(seed_cfg, tcfg, whisper_cfg=enc, device=dev,
                      draws_fn=_draws_fn(run.seed, TrainDraws,
                                         seed_cfg.model_params.DiT.class_dropout_prob))
    weights.fill(modules(trainer), cfg["init"], run.seed, dev)
    start = {"p0": {n: p.detach().clone() for n, p in trainer.state.params.items()},
             "opt": copy.deepcopy(trainer.state.opt_state)}
    dataset = FTDataset(data_dir, trainer.sr, tcfg.batch_size, seed=run.seed)
    trainer.train(Feed(dataset, 0, []))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.log(f"set-up epoch: {len(trainer.history)} steps, mel buckets "
            f"{sorted({h['T'] for h in trainer.history})}, dataset {len(secs)} clips, "
            f"{sum(secs):.0f} s, {len(trainer._feat_cache)} clips' features cached")
    return {"trainer": trainer, "dataset": dataset, "data_dir": data_dir, "start": start,
            "epoch": 1, "hop": trainer.hop}


def restart(trainer, start: dict) -> None:
    """The trainer back at step 0: the seeded weights and a fresh optimizer
    state (the feature cache and the built kernels stay)."""
    with torch.no_grad():
        for n, p in trainer.state.params.items():
            p.copy_(start["p0"][n])
    trainer.state = trainer.state._replace(opt_state=copy.deepcopy(start["opt"]), step=0)


FEATS = ("s_alt", "s_ori", "style", "mels")


def _recorded(step_fn, snap: dict, b1: float):
    """``step_fn`` that keeps what the check compares: the prepared features
    of steps 0-2, the first gradient as the optimizer got it (after step 0)
    and the parameters after step 2."""
    def step(state, feats, key, local_rows=False):
        k = state.step
        if k < 3:
            snap.setdefault("feats", []).append({n: feats[n].detach().clone() for n in FEATS})
        new, metrics = step_fn(state, feats, key, local_rows=local_rows)
        if k == 0:
            opt = new.opt_state
            snap["g1"] = {n: m / (1 - b1) for g, names in opt.names.items()
                          for n, m in zip(names, opt.groups[g].mu)}
        elif k == 2:
            snap["p3"] = {n: p.detach().clone() for n, p in new.params.items()}
        return new, metrics
    return step


def modules(trainer) -> dict:
    return {"whisper": trainer.whisper, "campplus": trainer.campplus, "vc": trainer.model}


def _run_steps(run, state, **feed):
    """One ``Trainer.train`` call over one epoch's batches, cut by ``feed``'s
    limit or deadline; returns (history entries, batches)."""
    trainer = state["trainer"]
    log: list = []
    h0 = len(trainer.history)
    trainer.train(Feed(state["dataset"], state["epoch"], log, **feed))
    state["epoch"] += 1
    return trainer.history[h0:], log


def _synced(step_fn, times: list):
    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out
    return timed


def window(run, state):
    tr, trainer = run.traffic, state["trainer"]
    if run.trace:
        n = int(tr.get("trace", {}).get("steps", 4))
        with SubWindow(run.device) as sw:
            with torch.profiler.record_function("vcbench.window"):
                hist, log = _run_steps(run, state, limit=n)
        run.subwindow = sw.result
        run.records["traced"] = (hist, log)
    restart(trainer, state["start"])
    snap = {"p0": state["start"]["p0"]}
    step_fn = trainer.step_fn
    times: list = []
    timed = _synced(step_fn, times) if run.trace and run.device.type == "cuda" else step_fn
    trainer.step_fn = _recorded(timed, snap, trainer.optimizer.b1)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    hist, log = [], []
    while time.perf_counter() < deadline:
        h, b = _run_steps(run, state, deadline=deadline)
        hist += h
        log += b
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    state["closed"] = time.perf_counter() - t0
    trainer.step_fn = step_fn
    frames = sum(int((b.wave_lengths // state["hop"]).sum()) for b in log[: len(hist)])
    snap["losses"] = [float(h["loss"]) for h in hist[:3]]
    state["snap"], state["first"] = snap, log[:3]
    state["frames"], state["steps"] = frames, len(hist)
    run.records.update(window=hist, step_s=times)
    run.log(f"window: {len(hist)} steps, {frames} real mel frames, {state['closed']:.2f} s")


def end_to_end(run, state):
    return {"train_frames_per_s": state["frames"] / state["closed"]}


def counts(run, state):
    return state["steps"], 0


# ---------------------------------------------------------------------------
# the check

def reference_steps(run, state, builder, lower: bool = False, half: bool = False) -> dict:
    """The frozen reference's three steps; ``lower``: the control (content
    encoder at fp8 where the configuration states bf16, the trained model's
    products in TF32 where it states f32); ``half``: a planted fault, half
    of each batch left out and the mean taken over the rest."""
    from vcbench.ref.dsp.mel import MelFrontend
    from vcbench.ref.models.campplus import CAMPPlus
    from vcbench.ref.models.vc import TrainDraws, VCModel
    from vcbench.ref.models.whisper import WhisperEncoder
    from vcbench.ref.train.optim import make_optimizer, warmup_cosine
    from vcbench.ref.train.step import prepare_batch, train_step
    cfg, tr, dev = run.config, run.traffic, run.device
    seed_cfg, enc, _ = builder.configs("vcbench.ref", cfg)
    mp = seed_cfg.model_params
    tcfg = trainer_config(tr, run.seed)
    whisper = WhisperEncoder(enc).to(dev).eval().requires_grad_(False)
    campplus = CAMPPlus(feat_dim=80, embedding_size=mp.style_encoder.dim).to(dev).eval()
    campplus.requires_grad_(False)
    model = VCModel(mp).to(dev).train()
    weights.fill({"whisper": whisper, "campplus": campplus, "vc": model}, cfg["init"],
                 run.seed, dev)
    sp = seed_cfg.preprocess_params.spect_params
    mel_fn = MelFrontend(seed_cfg.preprocess_params.sr, sp)
    optimizer = make_optimizer(warmup_cosine(tcfg.base_lr, tcfg.warmup_steps, tcfg.max_steps),
                               grad_clip=tcfg.grad_clip)
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    opt_state = optimizer.init(params)
    draws_fn = _draws_fn(run.seed, TrainDraws, mp.DiT.class_dropout_prob)
    hooks = control.fp8(whisper) if lower else []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = lower
    out = {"losses": [], "feats": []}
    try:
        for s, batch in enumerate(state["first"]):
            with torch.no_grad():
                feats = prepare_batch(batch, np.random.default_rng((tcfg.seed, s)),
                                      mel_fn=mel_fn, whisper=whisper, campplus=campplus,
                                      hop=sp.hop_length, mel_bucket=tcfg.mel_bucket,
                                      perturb=(tcfg.perturb_min, tcfg.perturb_max), device=dev)
            out["feats"].append({n: feats[n] for n in FEATS})
            draws = draws_fn((tcfg.seed, s), tuple(feats["mels"].shape), dev)
            if half:
                feats = {k: (v[:1] if v.dim() else v) for k, v in feats.items()}
                draws = type(draws)(*(None if d is None else d[:1] for d in draws))
            loss, grads, gnorm, opt_state = train_step(model, optimizer, opt_state, feats, draws)
            out["losses"].append(float(loss))
            if s == 0:
                factor = min(1.0, tcfg.grad_clip / float(gnorm))
                out["g1"] = {n: g.detach() * factor for n, g in grads.items()}
        out["d3"] = {n: p.detach() - p0[n] for n, p in params.items()}
    finally:
        for h in hooks:
            h.remove()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def leaf_gaps(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger of
    the reference leaf's norm and the median leaf's."""
    norms = {n: float(ref[n].float().norm()) for n in keep}
    med = statistics.median(norms.values())
    return max(abs(float(prog[n].float().norm()) - norms[n]) / max(norms[n], med)
               for n in keep)


def feat_gap(prog: list, ref: list) -> float:
    """The worst relative gap, ||p - r|| / ||r||, of the three steps'
    prepared features (content of both waves, style, mel)."""
    return max(float((ps[n].float() - rs[n].float()).norm() / rs[n].float().norm().clamp_min(1e-30))
               for ps, rs in zip(prog, ref) for n in FEATS)


def readings(snap: dict, ref: dict) -> dict:
    gnorm = {n: float(g.float().norm()) for n, g in ref["g1"].items()}
    med = statistics.median(gnorm.values())
    keep = [n for n, v in gnorm.items() if v >= 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(snap["losses"], ref["losses"]))
    d3 = {n: snap["p3"][n] - snap["p0"][n] for n in keep}
    return {"feat_rel_gap": feat_gap(snap["feats"], ref["feats"]), "loss_rel_gap": loss,
            "grad_leaf_gap": leaf_gaps(snap["g1"], ref["g1"], keep),
            "change_leaf_gap": leaf_gaps(d3, ref["d3"], keep), "leaves": len(keep)}


CHECKED = ("feat_rel_gap", "loss_rel_gap", "grad_leaf_gap", "change_leaf_gap")


def check(run, state, builder):
    spec = run.traffic["check"]["limit"]
    snap = state["snap"]
    state.pop("trainer")
    if len(state["first"]) < 3 or "p3" not in snap:
        shutil.rmtree(state["data_dir"], ignore_errors=True)
        run.log("the window took fewer than three steps: nothing to compare")
        return {k: (math.inf, float(spec[k])) for k in CHECKED}
    run.records.clear()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        got = readings(snap, reference_steps(run, state, builder))
    finally:
        shutil.rmtree(state["data_dir"], ignore_errors=True)
    run.log(f"reference over 3 steps in {time.perf_counter() - t0:.1f} s "
            f"({got['leaves']} leaves compared)")
    return {k: (got[k], float(spec[k])) for k in CHECKED}
