"""Closed loop over ``VoiceConverterV2.convert_voice_with_streaming``: one
client converting a folder of files with the AR on (accent and style), each
request sent when the last one's final chunk came back.

Every request caps each AR row at its source span's length
(``cap_to_source``) and keeps the numbers the check compares
(``keep_intermediates``: HuBERT's features, the quantizers' projections, the
decode's logits, the sampler's states and estimates), brought to the host
once the request has returned, so every request pays the same and the check
can read any of them. The window sends requests for
``--seconds`` and closes when the last one sent has returned.
``audio_s_per_s``: the output audio seconds of the window's requests over
the window's seconds. With ``--trace 1`` the stream's first
``trace.requests`` requests run under the profiler before the window opens,
and the window's requests record their stages as spans (``profile=True``).
"""

from __future__ import annotations

import itertools
import time

import torch

from vcbench import traffic as T, v1, v2
from vcbench.trace import SubWindow


def setup(run, builder):
    conv = builder.program(run.config, run.device)
    builder.fill(conv, run.config, run.seed, run.device)
    inputs = v1.make_inputs(run.traffic, run.seed)
    plans = v2.warm(conv, run.config, run.traffic, inputs, run.seed, run.device)
    run.log(f"warmed {plans} plans")
    return {"conv": conv, "inputs": inputs, "done": []}


def _one(run, state, req: T.Request, t0: float, profile: bool) -> v2.Done:
    return v2.run(state["conv"], run.traffic, req, state["inputs"][req.slot], run.seed,
                  run.device, t0, profile)


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


def end_to_end(run, state):
    sr = run.config["v2"]["sr"]
    audio = sum(len(d.wave) for d in state["done"]) / sr
    return {"audio_s_per_s": audio / state["closed"]}


def counts(run, state):
    done = state["done"]
    return len(done), sum(d.error is not None for d in done)


def check(run, state, builder):
    return v2.check(run, state, builder)
