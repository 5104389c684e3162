"""Closed loop over the F0-conditioned ``VoiceConverter.convert_with_streaming``:
one client converting a folder of sung files, each request sent when the
last one's final chunk came back, as ``offline.py``'s loop does.

Every request keeps the numbers the check compares (``keep_intermediates``:
RMVPE's salience, the F0 and its coarse bins, the content features, the
regulator's conditions), brought to the host once it has returned, so every
request pays the same and the check can read any of them. The window sends
requests for ``--seconds`` and closes when the last one sent has returned.
``audio_s_per_s``: the seconds of audio those requests converted over the
window's seconds. With ``--trace 1`` the stream's first ``trace.requests``
requests run under the profiler before the window opens, and the window's
requests record their stages as spans (``profile=True``).
"""

from __future__ import annotations

import itertools
import time

import torch

from vcbench import svc, traffic as T, v1
from vcbench.drivers.offline import counts, end_to_end, launch_counts  # noqa: F401
from vcbench.trace import SubWindow


def setup(run, builder):
    conv = builder.program(run.config, run.device)
    builder.fill(conv, run.config, run.seed, run.device)
    inputs = svc.make_inputs(run.traffic, run.seed)
    plans = v1.warm(conv, run.config, run.traffic, inputs, run.seed, run.device)
    run.log(f"warmed {plans} plans")
    return {"conv": conv, "inputs": inputs, "done": []}


def _one(run, state, req: T.Request, t0: float, profile: bool) -> svc.Done:
    return svc.run(state["conv"], run.traffic, req, state["inputs"][req.slot], run.seed,
                   run.device, t0, profile)


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
            f"finished, {state['closed']:.2f} s, of which {sum(d.keep_s for d in done):.3f} s "
            f"bringing the kept numbers to the host")


def check(run, state, builder):
    return svc.check(run, state, builder)
