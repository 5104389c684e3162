"""A short profiled sub-window, reduced in the process to a few numbers.

``torch.profiler`` records the host's operators and the device's kernels
over the sub-window; nothing is written to disk. The reduction keeps:

- ``window_s``: the length of the sub-window's ``vcbench.window`` span (it
  opens after and closes before a device synchronise), and ``busy_s``: the
  union of the device's operation intervals (kernels, copies, sets) inside
  it;
- ``kernels``: [(name, seconds)] of every device operation, for the
  per-layer readers that sum a kernel's device time by its name;
- ``device_ops``: the ten names that took the most device time;
- ``idle_gaps``: the ten longest stretches with nothing on the device, each
  named by the innermost benchmark or pipeline span and the innermost host
  operator open at its middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


class SubWindow:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.result: dict | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce(self.prof, self.t1 - self.t0)
        return False


def _raw(prof):
    """(device ops, host spans, host ops) as (start ns, end ns, name) from
    the profiler's raw events, without building its event tree."""
    dev, spans, ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type().name
        a = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
        d = e.duration_ns() if hasattr(e, "duration_ns") else 1000 * e.duration_us()
        name = e.name()
        if kind == "CPU":
            ops.append((a, a + d, name))
            if e.is_user_annotation() or name.startswith("vcbench."):
                spans.append((a, a + d, name))
        elif kind == "CUDA" and not e.is_user_annotation():
            dev.append((a, a + d, name))
    return dev, sorted(spans), sorted(ops)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, starts, t):
    """The shortest span of ``spans`` (sorted by start) open at ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[:i]):
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else None


def short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def reduce(prof, window_s: float) -> dict:
    dev, spans, ops = _raw(prof)
    per_name: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        per_name[name] += (b - a) * 1e-9
    # the profiled stretch on the profiler's clock: the outermost benchmark
    # span (``vcbench.window``) where there is one
    outer = [s for s in spans if s[2] == "vcbench.window"]
    if outer:
        lo, hi = outer[0][0], outer[0][1]
    elif ops or dev:
        lo = min([a for a, _, _ in ops] + [a for a, _, _ in dev])
        hi = max([b for _, b, _ in ops] + [b for _, b, _ in dev])
    else:
        lo = hi = 0
    merged = _union([(max(a, lo), min(b, hi)) for a, b, _ in dev if b > lo and a < hi])
    busy_s = sum(b - a for a, b in merged) * 1e-9
    gaps, prev = [], lo
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    span_starts = [s[0] for s in spans]
    op_starts = [s[0] for s in ops]
    idle = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        span = _innermost(spans, span_starts, mid) or "no span"
        op = _innermost(ops, op_starts, mid) or "no host op"
        idle.append([short(f"{span} / {op}"), (b - a) * 1e-9])
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (hi - lo) * 1e-9 if outer else window_s, "busy_s": busy_s,
            "kernels": dict(per_name),
            "device_ops": [[short(n), s] for n, s in top[:10]],
            "idle_gaps": idle}


def kernel_seconds(trace: dict, patterns) -> float:
    """Device seconds of the operations whose name holds any of ``patterns``."""
    return sum(s for n, s in trace["kernels"].items() if any(p in n for p in patterns))
