"""The port's stage-timing helpers (seedvc_tpu_torch/core/profiling.py) on
the CPU: stage accounting, named spans in a ``torch.profiler`` run, and the
device wait."""

import pytest
import torch

from seedvc_tpu_torch.core import profiling

torch.set_num_threads(1)


def test_stage_timer_accumulates():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer("a"):
            pass
    with timer("b"):
        pass
    rep = timer.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1
    assert rep["a"]["seconds"] >= 0.0 and rep["b"]["seconds"] >= 0.0


def test_stage_timer_counts_a_stage_that_raises():
    timer = profiling.StageTimer()
    with pytest.raises(ValueError):
        with timer("a"):
            raise ValueError("stage failed")
    assert timer.report()["a"]["calls"] == 1


def _span_names(body) -> set:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    return {e.key for e in prof.key_averages()}


def test_stage_is_a_named_span_in_a_profile():
    timer = profiling.StageTimer()

    def body():
        with timer("semantic"):
            torch.ones(8) @ torch.ones(8)

    assert "semantic" in _span_names(body)


def test_annotate_is_a_named_span_in_a_profile():
    def body():
        with profiling.annotate("vocode"):
            torch.ones(8) @ torch.ones(8)

    assert "vocode" in _span_names(body)


def test_probe_ready_returns_its_argument():
    x = torch.ones(3)
    assert profiling.probe_ready(x) is x
    assert profiling.probe_ready([1]) == [1]
