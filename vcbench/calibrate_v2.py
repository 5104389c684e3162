"""Readings for the limits of the v2 cell's comparison, in one process.

``python -m vcbench.calibrate_v2 --workload v2_voice --seeds 1,2,... --control-seeds 1,2,3
--fault-seeds 1,2 [--faults kv,rope,branch,prompt,lens,shift]``

For each seed it fills the program's weights anew, converts the two
requests a run would check (the cycle's longest and one drawn from the
seed) and prints the compared numbers (``v2.CHECKED``) against the frozen
reference: the lower reading is the largest over the seeds. For each
control seed the reference with HuBERT, the quantizers, the AR and the DiT
at fp8 (e4m3, the sampler's state too) takes the program's place on the
program's inputs to each stage; for each fault seed the program runs with
each planted fault of ``--faults``: in the AR's decode (``kv``: each step's
key and value written one slot past the one its mask reads; ``rope``: the
decode's positions one past the prompt's), in the sampler (``branch``: the
text-only branch left out of the CFG stack; ``prompt``: the prompt's mel
left out of every branch; ``lens``: the padded frames past the chunk
attended as keys), or in the content stage (``shift``: the 16 kHz waves
HuBERT reads one sample late). It prints each number's largest sound
reading and the least reading of each other side. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from vcbench import calibrate, spec, v1, v2


def _kv_one_off():
    from seedvc_tpu_torch.models.ar import ARAttention
    orig = ARAttention.forward

    def forward(self, x, rope, masked, k_cache=None, v_cache=None, write_pos=None):
        return orig(self, x, rope, masked, k_cache, v_cache,
                    None if write_pos is None else write_pos + 1)
    ARAttention.forward = forward
    return lambda: setattr(ARAttention, "forward", orig)


def _rope_one_off():
    from seedvc_tpu_torch.models.ar import ARTransformer
    orig = ARTransformer.decode_step

    def decode_step(self, x_emb, input_pos, *a, **k):
        return orig(self, x_emb, input_pos + 1, *a, **k)
    ARTransformer.decode_step = decode_step
    return lambda: setattr(ARTransformer, "decode_step", orig)


def _text_branch_dropped():
    from seedvc_tpu_torch.models import cfm_v2
    orig = cfm_v2.cfg_branches

    def cfg_branches(prompt_x, style, mu, cfg_rates, random_voice):
        branches, weights = orig(prompt_x, style, mu, cfg_rates, random_voice)
        if len(branches) == 3:  # [full / unconditional], as with no similarity rate
            r0 = float(cfg_rates[0])
            return [branches[0], branches[2]], (1.0 + r0, -r0)
        return branches, weights
    cfm_v2.cfg_branches = cfg_branches
    return lambda: setattr(cfm_v2, "cfg_branches", orig)


def _prompt_dropped():
    from seedvc_tpu_torch.models import cfm_v2
    orig = cfm_v2.cfg_branches

    def cfg_branches(prompt_x, style, mu, cfg_rates, random_voice):
        branches, weights = orig(prompt_x, style, mu, cfg_rates, random_voice)
        return [(b[0].mul(0), *b[1:]) for b in branches], weights
    cfm_v2.cfg_branches = cfg_branches
    return lambda: setattr(cfm_v2, "cfg_branches", orig)


def _lens_dropped():
    from seedvc_tpu_torch.pipelines import convert_v2
    orig = convert_v2.euler_solve_multicfg

    def solve(estimate_fn, noise, mu, x_lens, *a, **k):
        return orig(estimate_fn, noise, mu, None, *a, **k)
    convert_v2.euler_solve_multicfg = solve
    return lambda: setattr(convert_v2, "euler_solve_multicfg", orig)


def _shifted_16k():
    from seedvc_tpu_torch.pipelines import convert_v2
    orig = convert_v2.resample

    def resample(w, sr_in, sr_out):
        out = orig(w, sr_in, sr_out)
        return torch.cat([out[:1] * 0, out[:-1]]) if sr_out == 16000 else out
    convert_v2.resample = resample
    return lambda: setattr(convert_v2, "resample", orig)


FAULTS = {"kv": _kv_one_off, "rope": _rope_one_off, "branch": _text_branch_dropped,
          "prompt": _prompt_dropped, "lens": _lens_dropped, "shift": _shifted_16k}


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
        inputs = v1.make_inputs(tr, seed)
        undo = FAULTS[fault]() if fault else None
        try:
            ds = [v2.run(conv, tr, d.req, inputs[d.req.slot], seed, device,
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
            got = v2.reference_readings(ref, tr, inputs, ds, seed, device,
                                        quantised=quantised)
            rows.append({"side": side, "seed": seed, **got,
                         "seconds": [d.req.source_seconds for d in ds],
                         "ar_rows": [d.info["ar_batch"] for d in ds],
                         "took_s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        del ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    names = sorted({r["side"] for r in rows} - {"program"})
    for k in v2.CHECKED:
        prog = [r[k] for r in rows if r["side"] == "program"]
        print(json.dumps({k: {"lower": max(prog, default=None),
                              **{f"least {s}": min(r[k] for r in rows if r["side"] == s)
                                 for s in names}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
