"""Readings for the limits of a cell's comparison, in one process.

``python -m vcbench.calibrate --workload v1_offline --seeds 1,2,... --control-seeds 1,2,3``

For each seed it fills the program's weights anew, runs what a run would
compare (a v1 cell: the cycle's longest request and one drawn from the
seed; the stream: a short window, its stretches sampled as a run samples
them; fine-tuning: the set-up epoch and a one-second window) and prints the
compared numbers against the frozen reference: the lower reading is the
largest over the seeds. For each control seed it does the same with the
control in the program's place (the reference with its bf16 parts at fp8,
or for fine-tuning its f32 products in TF32), and ``--fault-seeds`` /
``--cache-fault-seeds`` plant a fault (fine-tuning: half of each batch; the
cached rows swapped; the stream: SOLA's offset or fade). It prints each
number's largest sound reading and the least reading of each other side.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vcbench import spec, traffic as T, v1


def picks(tr: dict, seed: int) -> list[v1.Done]:
    """The cycle's longest request and one other, drawn from the seed."""
    reqs = [r for r, _ in zip(T.stream(tr, seed), range(int(tr["requests"])))]
    longest = max(reqs, key=lambda r: r.source_seconds)
    rest = [r for r in reqs if r is not longest]
    other = rest[int(T.rng(seed, 4).integers(len(rest)))]
    return [v1.Done(req=r, start=0.0) for r in (longest, other)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="",
                   help="fine-tuning: the half-batch fault; the stream: the SOLA faults")
    p.add_argument("--cache-fault-seeds", default="",
                   help="fine-tuning: cached style and content rows swapped on a cache hit")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    cell = spec.load_cell(Path.cwd(), a.workload)
    cfg, tr = cell.config, cell.traffic
    bld = spec.builder(cfg, cell.base)
    if tr["driver"] == "stream":
        return stream(cell, bld, a, device)
    if tr["driver"] == "train":
        return train(cell, bld, a, device)
    conv = bld.program(cfg, device)
    sr_in = int(tr["sample_rate"])
    rows = []
    for seed in [int(s) for s in a.seeds.split(",") if s]:
        t0 = time.perf_counter()
        bld.fill(conv, cfg, seed, device)
        inputs = v1.make_inputs(tr, seed)
        ds = picks(tr, seed)
        for d in ds:
            inp = inputs[d.req.slot]
            _, d.wave, _ = conv.convert(inp.source, sr_in, inp.reference, sr_in,
                                        **v1.convert_kwargs(tr, d.req, seed, device))
        refs = v1.reference_waves(cfg, tr, inputs, ds, seed, device, bld)
        errs = [v1.rel_err(d.wave, r) for d, r in zip(ds, refs)]
        row = {"side": "program", "seed": seed, "wave_rel_err": max(errs), "each": errs,
               "seconds": [d.req.source_seconds for d in ds],
               "took_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    del conv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        inputs = v1.make_inputs(tr, seed)
        ds = picks(tr, seed)
        low = v1.reference_waves(cfg, tr, inputs, ds, seed, device, bld, quantised=True)
        refs = v1.reference_waves(cfg, tr, inputs, ds, seed, device, bld)
        errs = [v1.rel_err(x, r) for x, r in zip(low, refs)]
        row = {"side": "control", "seed": seed, "wave_rel_err": max(errs), "each": errs,
               "took_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    prog = [r["wave_rel_err"] for r in rows if r["side"] == "program"]
    ctrl = [r["wave_rel_err"] for r in rows if r["side"] == "control"]
    print(json.dumps({"lower": max(prog, default=None), "upper": min(ctrl, default=None)}))
    return 0


STREAM_FAULTS = {
    "offset": lambda S: setattr(S, "sola_offset", lambda chunk, tail, search: search),
    "fade": lambda S: setattr(S, "crossfade_add",
                              lambda chunk, tail: np.ascontiguousarray(chunk, np.float32)),
}


def stream(cell, bld, a, device) -> int:
    """The stream's readings: each seed's program over a short window; the
    control's block spans; the planted SOLA faults (``--fault-seeds``: its
    offset at the far end of the search, its fade skipped)."""
    import argparse as ap
    from seedvc_tpu_torch.pipelines import streaming as S
    from vcbench.drivers import stream as drv
    from vcbench.run import Run
    spec_ = cell.traffic["check"]
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = {int(s) for s in a.control_seeds.split(",") if s}
    faults = [(f, int(s)) for s in a.fault_seeds.split(",") if s for f in STREAM_FAULTS]
    rows = []
    for fault, seed in [(None, s) for s in sorted(set(seeds) | control)] + faults:
        t0 = time.perf_counter()
        run = Run(ap.Namespace(seed=seed, seconds=4.0, trace="0"), cell, device, t0)
        orig = (S.sola_offset, S.crossfade_add)
        if fault:
            STREAM_FAULTS[fault](S)
        try:
            state = drv.setup(run, bld)
            drv.window(run, state)
        finally:
            S.sola_offset, S.crossfade_add = orig
        stretches = drv.picks(state, int(spec_["runs"]), int(spec_["run_blocks"]), seed)
        del state["stream"], state["conv"]
        run.records.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        refs, joins = drv.reference_blocks(run, state, stretches, bld)
        got = drv.readings(stretches, refs, joins)
        side = f"fault: sola {fault}" if fault else "program"
        if fault or seed in seeds:
            rows.append({"side": side, "seed": seed, **got,
                         "blocks": sum(len(s) for s in stretches),
                         "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        if not fault and seed in control:
            low, _ = drv.reference_blocks(run, state, stretches, bld, quantised=True)
            as_prog = [[dict(e, raw=r) for e, r in zip(s, ls)] for s, ls in zip(stretches, low)]
            rows.append({"side": "control", "seed": seed,
                         **drv.readings(as_prog, refs, joins),
                         "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
    sides = sorted({r["side"] for r in rows} - {"program"})
    for k in drv.CHECKED:
        prog = [r[k] for r in rows if r["side"] == "program"]
        print(json.dumps({k: {"lower": max(prog, default=None),
                              **{f"least {s}": min(r[k] for r in rows if r["side"] == s)
                                 for s in sides}}}))
    return 0


def _swap_cached_rows():
    """A planted fault: on a feature-cache hit the batch's cached style and
    content rows come back in the wrong order. Returns its undo."""
    from seedvc_tpu_torch.train.trainer import Trainer
    orig = Trainer.prepare_batch

    def prepare_batch(self, batch, *args, **kw):
        hit = all(int(i) in self._feat_cache for i in batch.ids)
        feats = orig(self, batch, *args, **kw)
        if hit:
            feats["s_ori"], feats["style"] = feats["s_ori"].flip(0), feats["style"].flip(0)
        return feats
    Trainer.prepare_batch = prepare_batch
    return lambda: setattr(Trainer, "prepare_batch", orig)


def train(cell, bld, a, device) -> int:
    """Fine-tuning's readings: each seed's trainer through its set-up epoch
    and a one-second window, whose first three steps are compared as a run
    compares them; the control's three steps and the half-batch fault's,
    against the reference's."""
    import argparse as ap
    import shutil
    from vcbench.drivers import train as drv
    from vcbench.run import Run
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = {int(s) for s in a.control_seeds.split(",") if s}
    faults = {int(s) for s in a.fault_seeds.split(",") if s}
    cache_faults = {int(s) for s in a.cache_fault_seeds.split(",") if s} - set(seeds)
    rows = []
    for seed in sorted(set(seeds) | control | faults | cache_faults):
        t0 = time.perf_counter()
        run = Run(ap.Namespace(seed=seed, seconds=1.0, trace="0"), cell, device, t0)
        undo = _swap_cached_rows() if seed in cache_faults else None
        try:
            state = drv.setup(run, bld)
            drv.window(run, state)
        finally:
            if undo is not None:
                undo()
        state.pop("trainer")
        run.records.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = drv.reference_steps(run, state, bld)
        if seed in seeds:
            rows.append({"side": "program", "seed": seed, **drv.readings(state["snap"], ref),
                         "losses": state["snap"]["losses"], "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        if seed in cache_faults:
            rows.append({"side": "fault: cached rows swapped", "seed": seed,
                         **drv.readings(state["snap"], ref), "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        if seed in control:
            low = drv.reference_steps(run, state, bld, lower=True)
            zero = {n: torch.zeros_like(d) for n, d in low["d3"].items()}
            as_prog = {"losses": low["losses"], "g1": low["g1"], "p0": zero, "p3": low["d3"],
                       "feats": low["feats"]}
            rows.append({"side": "control", "seed": seed, **drv.readings(as_prog, ref),
                         "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        if seed in faults:
            bad = drv.reference_steps(run, state, bld, half=True)
            zero = {n: torch.zeros_like(d) for n, d in bad["d3"].items()}
            as_prog = {"losses": bad["losses"], "g1": bad["g1"], "p0": zero, "p3": bad["d3"],
                       "feats": bad["feats"]}
            rows.append({"side": "fault: half the batch", "seed": seed,
                         **drv.readings(as_prog, ref), "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        shutil.rmtree(state["data_dir"], ignore_errors=True)
    sides = sorted({r["side"] for r in rows} - {"program"})
    for k in drv.CHECKED:
        prog = [r[k] for r in rows if r["side"] == "program"]
        print(json.dumps({k: {"lower": max(prog, default=None),
                              **{f"least {s}": min(r[k] for r in rows if r["side"] == s)
                                 for s in sides}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
