"""Stage timing and device timing (port of ``seedvc_tpu/core/profiling.py``).

- :class:`StageTimer`: per-stage wall-clock accounting for the pipelines,
  each stage also a named span in a ``torch.profiler`` trace;
- :func:`trace`: a ``torch.profiler`` run that writes a TensorBoard-loadable
  trace into a directory (the JAX package's ``jax.profiler`` trace);
- :func:`annotate`: a named span (``torch.profiler.record_function``);
- :func:`probe_ready`: wait for a tensor's device work to finish;
- :func:`cuda_time_ms`: a function's device time per call, by CUDA events.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage across a pipeline run.

    >>> timer = StageTimer()
    >>> with timer("semantic"):
    ...     pass
    >>> timer.report()  # {'semantic': {'seconds': ..., 'calls': 1}}
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled  # False: stages run untimed and unrecorded
        self._acc: dict[str, float] = {}
        self._calls: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with annotate(stage):
                yield
        finally:
            self._acc[stage] = self._acc.get(stage, 0.0) + time.perf_counter() - t0
            self._calls[stage] = self._calls.get(stage, 0) + 1

    def report(self) -> dict:
        return {stage: {"seconds": self._acc[stage], "calls": self._calls[stage]}
                for stage in self._acc}

    def total(self) -> float:
        """Seconds over every stage."""
        return sum(self._acc.values())


def probe_ready(x):
    """Wait until the device work behind ``x`` has finished (a device
    synchronise for a CUDA tensor; nothing otherwise). Returns ``x``."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the block (host, and the device when CUDA is up) and write a
    TensorBoard trace under ``logdir``; ``None`` or ``""`` profiles nothing."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a ``torch.profiler`` trace (cheap when none runs)."""
    with torch.profiler.record_function(name):
        yield


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls
    bracketed by CUDA events, after ``warmup`` calls. A spin kernel of about
    50 ms runs before the first event, so the host queues calls while it
    spins: a short kernel's time is the device's, not the host's dispatch
    rate. Calls whose dispatch outlasts the spin are still host-paced."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
