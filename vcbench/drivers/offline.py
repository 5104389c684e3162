"""Closed loop over ``VoiceConverter.convert_with_streaming``: one client
converting a folder of files, each request sent when the last one's final
chunk came back.

The window sends requests for ``--seconds`` and closes when the last one
sent has returned, so it holds whole requests only. ``audio_s_per_s``:
the seconds of audio those requests converted over the window's seconds
(from its opening to that last return). With ``--trace 1`` the window's
first ``trace.requests`` requests of the stream run under the profiler
before the window opens, and the window's requests run with
device-synchronised stages (``profile=True``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from vcbench import traffic as T, v1
from vcbench.trace import SubWindow


def setup(run, builder):
    conv = builder.program(run.config, run.device)
    builder.fill(conv, run.config, run.seed, run.device)
    inputs = v1.make_inputs(run.traffic, run.seed)
    plans = v1.warm(conv, run.config, run.traffic, inputs, run.seed, run.device)
    run.log(f"warmed {plans} plans")
    return {"conv": conv, "inputs": inputs, "done": []}


def _one(run, state, req: T.Request, t0: float, profile: bool) -> v1.Done:
    tr = run.traffic
    inp = state["inputs"][req.slot]
    sr_in = int(tr["sample_rate"])
    d = v1.Done(req=req, start=time.perf_counter() - t0)
    pieces = []
    with torch.profiler.record_function("vcbench.request"):
        gen = state["conv"].convert_with_streaming(
            inp.source, sr_in, inp.reference, sr_in, profile=profile,
            **v1.convert_kwargs(tr, req, run.seed, run.device))
        try:
            for _, piece, stats in gen:
                pieces.append(piece)
                d.stages = stats["stages"]
            d.end = time.perf_counter() - t0
            d.wave = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        finally:
            gen.close()
    return d


def launch_counts() -> dict:
    """The program's own launch counters of K1 and K2."""
    from seedvc_tpu_torch.ops import anti_alias, attention
    return {"k1": attention.LAUNCHES, "k2": anti_alias.LAUNCHES}


def window(run, state):
    tr = run.traffic
    done = state["done"]
    reqs = T.stream(tr, run.seed)
    run.records["inputs"] = state["inputs"]
    if run.trace:
        # the profiled sub-window comes first, on a clock of its own
        n = int(tr.get("trace", {}).get("requests", 2))
        before = launch_counts()
        with SubWindow(run.device) as sw:
            with torch.profiler.record_function("vcbench.window"):
                t0 = time.perf_counter()
                traced = [_one(run, state, req, t0, False)
                          for req in itertools.islice(reqs, n)]
        run.subwindow = sw.result
        run.records["traced"] = traced
        run.records["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for req in reqs:
        if time.perf_counter() - t0 >= run.seconds:
            break
        done.append(_one(run, state, req, t0, run.trace))
    state["closed"] = time.perf_counter() - t0
    if run.trace:
        run.records["synced"] = done
    run.log(f"window: {len(done)} requests, {sum(d.wave is not None for d in done)} "
            f"finished, {state['closed']:.2f} s")


def end_to_end(run, state):
    sr = run.config["preset"]["preprocess_params"]["sr"]
    audio = sum(len(d.wave) for d in state["done"]) / sr
    return {"audio_s_per_s": audio / state["closed"]}


def counts(run, state):
    done = state["done"]
    return len(done), sum(d.error is not None for d in done)


def check(run, state, builder):
    state.pop("conv")
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return v1.check(run, state["done"], state["inputs"], builder)
