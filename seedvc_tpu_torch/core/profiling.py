"""Spans, stage timing and device timing (port of ``seedvc_tpu/core/profiling.py``).

- :class:`Span`: one timed stretch of host work: its name, host start and
  end (``perf_counter_ns``) and, on cuda, its device time from a pair of
  timing events at its edges;
- :class:`StageTimer`: per-stage wall-clock accounting for the pipelines,
  each stage a named span in a ``torch.profiler`` trace, and with
  ``record=True`` the port's span recorder;
- :func:`annotate`: a named span in a trace alone (``torch.profiler.record_function``);
- :func:`elapsed_ms`: the device time between two timing events, read only
  once the later one has completed;
- :func:`probe_ready`: wait for a tensor's device work to finish;
- :func:`cuda_time_ms`: a function's device time per call, by CUDA events.

The recorder never synchronises the device (``probe_ready`` and
``cuda_time_ms`` do, by design): an event pair is read after a wait the
caller already makes, or when ``query()`` says its end has completed. While
a stream is capturing a CUDA graph no plain event is recorded; events meant
for a graph are made with ``external=True`` by the code that captures it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _timing_events(device) -> Optional[tuple]:
    """A pair of timing events with the first recorded now on ``device``'s
    current stream, or None off cuda and while that stream captures a graph."""
    if device is None or torch.device(device).type != "cuda" or _capturing():
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    return start, end


def elapsed_ms(start, end) -> Optional[float]:
    """Device ms from ``start`` to ``end`` once ``end`` has completed, else None."""
    return start.elapsed_time(end) if end.query() else None


class Span:
    """One timed stretch: ``name``, ``start_ns`` / ``end_ns``
    (``perf_counter_ns``) and, when opened with a cuda ``device`` outside a
    capture, a pair of timing events whose time :meth:`device_s` gives."""

    __slots__ = ("name", "start_ns", "end_ns", "_events", "_device_s")

    def __init__(self, name: str, device=None):
        self.name = name
        self.end_ns: Optional[int] = None
        self._device_s: Optional[float] = None
        self._events = _timing_events(device)
        self.start_ns = time.perf_counter_ns()

    def close(self) -> "Span":
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.perf_counter_ns()
        return self

    @property
    def host_s(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-9

    def device_s(self) -> Optional[float]:
        """Device seconds between the span's events, once its end event has
        completed; None before that, and for a span without events."""
        if self._device_s is None and self._events is not None and self.end_ns is not None:
            ms = elapsed_ms(*self._events)
            if ms is not None:
                self._device_s, self._events = ms * 1e-3, None
        return self._device_s


class StageTimer:
    """Accumulates wall time per named stage across a pipeline run; each
    stage is a ``record_function`` span of its name.

    ``record=True`` makes it the run's span recorder as well: every stage is
    then a :class:`Span` in ``spans``, with a pair of timing events when
    ``device`` is cuda. ``count(key, n)`` adds to the innermost open stage's counts.
    ``enabled=False``: stages run untimed and unrecorded.

    >>> timer = StageTimer()
    >>> with timer("semantic"):
    ...     pass
    >>> timer.report()  # {'semantic': {'seconds': ..., 'calls': 1, 'device_seconds': None}}
    """

    def __init__(self, enabled: bool = True, record: bool = False, device=None):
        self.enabled = enabled
        self.record = record and enabled
        self.device = device
        self.spans: list[Span] = []
        self._open: list[str] = []
        self._acc: dict[str, float] = {}
        self._calls: dict[str, int] = {}
        self._counts: dict[str, dict] = {}
        self._inner: set[str] = set()  # stages opened inside another

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if not self.enabled:
            yield
            return
        with annotate(stage):
            span = Span(stage, self.device) if self.record else None
            if self._open:
                self._inner.add(stage)
            self._open.append(stage)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._acc[stage] = self._acc.get(stage, 0.0) + time.perf_counter() - t0
                self._calls[stage] = self._calls.get(stage, 0) + 1
                self._open.pop()
                if span is not None:
                    self.spans.append(span.close())

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` to counter ``key`` of the innermost open stage."""
        if self.enabled and self._open:
            c = self._counts.setdefault(self._open[-1], {})
            c[key] = c.get(key, 0) + n

    def device_seconds(self, stage: str) -> Optional[float]:
        """Σ device seconds of the recorded spans of ``stage``; None unless
        every one of them has completed device events."""
        times = [s.device_s() for s in self.spans if s.name == stage]
        return sum(times) if times and None not in times else None

    def report(self) -> dict:
        return {stage: {"seconds": self._acc[stage], "calls": self._calls[stage],
                        "device_seconds": self.device_seconds(stage),
                        **self._counts.get(stage, {})}
                for stage in self._acc}

    def total(self) -> float:
        """Seconds over every outermost stage (a stage opened inside another
        is already in its parent's seconds)."""
        return sum(v for k, v in self._acc.items() if k not in self._inner)


def probe_ready(x):
    """Wait until the device work behind ``x`` has finished (a device
    synchronise for a CUDA tensor; nothing otherwise). Returns ``x``."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


def annotate(name: str) -> torch.profiler.record_function:
    """Named span inside a ``torch.profiler`` trace, as a context manager
    (a few microseconds when none runs)."""
    return torch.profiler.record_function(name)


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
