"""Readings for the limits of the SVC cell's comparison, in one process.

``python -m vcbench.calibrate_svc --workload svc_offline --seeds 1,2,... --control-seeds 1,2,3
--fault-seeds 1,2 [--faults late,unflipped,mask]``

For each seed it fills the program's weights anew, converts the two
requests a run would check (the cycle's longest and one drawn from the
seed) and prints the compared numbers (``svc.CHECKED``) against the frozen
reference: the lower reading is the largest over the seeds. For each
control seed the reference with RMVPE in TF32 and the DiT and the sampler's
state at fp8 takes the program's place on the program's inputs to each
stage; for each fault seed the program runs with each planted fault of
``--faults``: ``late`` (the F0 of source and reference one frame late),
``unflipped`` (RMVPE's backward GRU run over the frames in their own order)
or ``mask`` (the regulator's F0 embedding replaced by its ``f0_mask``, as
with no F0). It prints each number's largest sound reading, the least
reading of each other side, and the fill's voiced share and coarse F0 bins
on the checked requests. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vcbench import calibrate, spec, svc


def _f0_late():
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    orig = VoiceConverter.extract_f0

    def extract_f0(self, *a, **k):
        return tuple(np.concatenate([f[:1] * 0, f[:-1]]) for f in orig(self, *a, **k))
    VoiceConverter.extract_f0 = extract_f0
    return lambda: setattr(VoiceConverter, "extract_f0", orig)


def _gru_unflipped():
    from seedvc_tpu_torch.models.rmvpe import RMVPE_E2E
    orig = RMVPE_E2E.gru

    def gru(self, h):
        return torch.cat([self.gru_fwd(h)[0], self.gru_bwd(h)[0]], dim=-1)
    RMVPE_E2E.gru = gru
    return lambda: setattr(RMVPE_E2E, "gru", orig)


def _f0_masked():
    from seedvc_tpu_torch.models.vc import VCModel
    orig = VCModel.regulate

    def regulate(self, features, ylens, target_len, f0=None, **k):
        return orig(self, features, ylens, target_len, None, **k)
    VCModel.regulate = regulate
    return lambda: setattr(VCModel, "regulate", orig)


FAULTS = {"late": _f0_late, "unflipped": _gru_unflipped, "mask": _f0_masked}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    cell = spec.load_cell(Path.cwd(), a.workload)
    cfg, tr = cell.config, cell.traffic
    bld = spec.builder(cfg, cell.base)
    n_bins = cfg["preset"]["model_params"]["length_regulator"]["n_f0_bins"]
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = [int(s) for s in a.control_seeds.split(",") if s]
    faults = [(f, int(s)) for s in a.fault_seeds.split(",") if s
              for f in a.faults.split(",") if f]
    conv = bld.program(cfg, device)
    runs = [(None, s) for s in sorted(set(seeds) | set(control))] + faults
    rows = []
    for fault, seed in runs:
        t0 = time.perf_counter()
        bld.fill(conv, cfg, seed, device)
        inputs = svc.make_inputs(tr, seed)
        undo = FAULTS[fault]() if fault else None
        try:
            ds = [svc.run(conv, tr, d.req, inputs[d.req.slot], seed, device,
                          time.perf_counter(), False) for d in calibrate.picks(tr, seed)]
        finally:
            if undo is not None:
                undo()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = bld.reference(cfg, device)
        bld.fill(ref, cfg, seed, device)
        sides = []
        if fault or seed in seeds:
            sides.append((f"fault: {fault}" if fault else "program", False))
        if not fault and seed in control:
            sides.append(("control", True))
        for side, quantised in sides:
            got = svc.reference_readings(ref, tr, inputs, ds, seed, device,
                                         quantised=quantised)
            rows.append({"side": side, "seed": seed, **got,
                         "seconds": [d.req.source_seconds for d in ds],
                         "f0": [svc.f0_share(d.kept, n_bins) for d in ds],
                         "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        del ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    names = sorted({r["side"] for r in rows} - {"program"})
    for k in svc.CHECKED:
        prog = [r[k] for r in rows if r["side"] == "program"]
        print(json.dumps({k: {"lower": max(prog, default=None),
                              **{f"least {s}": min(r[k] for r in rows if r["side"] == s)
                                 for s in names}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
