"""Per-stage wall-clock accounting for the pipelines."""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Accumulates wall time per named stage across a pipeline run.

    >>> timer = StageTimer()
    >>> with timer("semantic"):
    ...     pass
    >>> timer.report()  # {'semantic': {'seconds': ..., 'calls': 1}}
    """

    def __init__(self):
        self._acc: dict[str, float] = {}
        self._calls: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[stage] = self._acc.get(stage, 0.0) + time.perf_counter() - t0
            self._calls[stage] = self._calls.get(stage, 0) + 1

    def report(self) -> dict:
        return {stage: {"seconds": self._acc[stage], "calls": self._calls[stage]}
                for stage in self._acc}
