"""The port's stage-timing helpers (seedvc_tpu_torch/core/profiling.py) on
the CPU: stage accounting, named spans in a ``torch.profiler`` run, and the
device wait; and beside the JAX package's ``core/profiling.py``: a disabled
``StageTimer`` records nothing, ``total()`` is the sum of the stages'
seconds; the JAX package's ``trace(logdir)`` writes a trace under ``logdir``
(``None`` writes nothing), which the port does without. The span recorder
is tests/test_torch_spans.py's."""

import os

import pytest
import torch

from seedvc_tpu.core import profiling as jprofiling
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


def _run_stages(timer):
    for stage in ("a", "b", "a"):
        with timer(stage):
            sum(range(1000))
    return timer


@pytest.mark.parametrize("enabled", [True, False])
def test_stage_timer_enabled_and_total_as_jax(enabled):
    port = _run_stages(profiling.StageTimer(enabled=enabled))
    ref = _run_stages(jprofiling.StageTimer(enabled=enabled))
    assert port.enabled is ref.enabled is enabled
    assert ({k: v["calls"] for k, v in port.report().items()}
            == {k: v["calls"] for k, v in ref.report().items()}
            == ({"a": 2, "b": 1} if enabled else {}))
    for timer in (port, ref):
        assert timer.total() == pytest.approx(sum(timer._acc.values()))
        assert (timer.total() > 0) is enabled


def _files(d):
    return [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]


def test_trace_writes_a_trace_as_jax(tmp_path):
    """The JAX package's ``trace(logdir)``; the port has no exporter of its
    own (a ``torch.profiler`` session reads its spans)."""
    assert not hasattr(profiling, "trace")
    with jprofiling.trace(None):
        torch.ones(4) @ torch.ones(4)
    with jprofiling.trace(str(tmp_path / "jax")):
        with jprofiling.annotate("stage"):
            torch.ones(4) @ torch.ones(4)
    assert _files(tmp_path / "jax")
    assert os.listdir(tmp_path) == ["jax"]
