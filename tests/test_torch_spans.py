"""The port's span recorder (``seedvc_tpu_torch/core/profiling.py``) and the
spans and counters the pipelines record with it, on the CPU.

The recorder: disabled it keeps no span and makes no event; recorded spans
carry host stamps and, on cuda, device time once their end event has
completed; every stage is a ``record_function`` event under
``torch.profiler``; no plain event is made while a stream captures a graph
(``torch.cuda.Event`` and the capture test faked, as the CPU has neither).
Then the pipelines: ``prefetched`` reports the consumer's wait, a
``Trainer`` history entry carries its wait and step span,
``convert(profile=True)`` reports ``sample`` (with its Euler steps) and
``vocode``, and an eager ``StreamingConverter`` keeps a record a block with
its device fields None.
"""

import time

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.apps.audio_io import save_wav
from seedvc_tpu_torch.core import profiling
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.pipelines import streaming
from seedvc_tpu_torch.train.prefetch import prefetched
from seedvc_tpu_torch.train.trainer import Trainer, TrainerConfig
from torch_port_helpers import port_cfg, tiny_train_cfg, tiny_xlsr

torch.set_num_threads(1)
SR = 22050


class FakeEvent:
    """A timing event on the host clock, logged in ``made`` when built."""

    def __init__(self, made, enable_timing=False, **_):
        self.t = None
        made.append(self)

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda.Event`` faked and no capture running: the list of the
    events made."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: FakeEvent(made, **kw))
    monkeypatch.setattr(profiling, "_capturing", lambda: False)
    return made


def _nested(timer):
    with timer("outer"):
        with timer("inner"):
            timer.count("steps", 3)
        timer.count("steps")
    return timer


def test_disabled_recorder_keeps_no_span_and_makes_no_event(fake_cuda):
    timer = _nested(profiling.StageTimer(device="cuda"))
    assert timer.spans == [] and fake_cuda == []
    rep = timer.report()
    assert rep["inner"]["steps"] == 3 and rep["outer"]["steps"] == 1
    assert rep["inner"]["device_seconds"] is None and rep["outer"]["calls"] == 1
    assert timer.total() == pytest.approx(rep["outer"]["seconds"])
    off = _nested(profiling.StageTimer(enabled=False, record=True, device="cuda"))
    assert off.spans == [] and off.report() == {} and fake_cuda == []


def test_recorded_spans_carry_host_and_device_time(fake_cuda):
    timer = _nested(profiling.StageTimer(record=True, device="cuda"))
    inner, outer = timer.spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.host_s >= inner.host_s >= 0
    assert len(fake_cuda) == 4 and all(e.t is not None for e in fake_cuda)
    rep = timer.report()
    assert rep["outer"]["device_seconds"] >= rep["inner"]["device_seconds"] >= 0
    cpu = _nested(profiling.StageTimer(record=True))
    assert [s.name for s in cpu.spans] == ["inner", "outer"]
    assert all(s.device_s() is None and s.host_s >= 0 for s in cpu.spans)
    assert cpu.report()["outer"]["device_seconds"] is None


def test_no_plain_event_while_capturing(fake_cuda, monkeypatch):
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    timer = _nested(profiling.StageTimer(record=True, device="cuda"))
    step = profiling.Span("train.step", device="cuda").close()
    assert fake_cuda == []
    assert len(timer.spans) == 2
    assert all(s.device_s() is None and s.host_s >= 0 for s in timer.spans + [step])


def test_device_time_waits_for_the_end_event(fake_cuda):
    span = profiling.Span("s", device="cuda")
    assert len(fake_cuda) == 2 and span.device_s() is None  # open: its end not recorded
    span.close()
    fake_cuda[1].query = lambda: False  # recorded, not yet completed on the device
    assert span.device_s() is None and span.host_s >= 0
    fake_cuda[1].query = lambda: True
    assert span.device_s() >= 0 and span.device_s() == span.device_s()


@pytest.mark.parametrize("record", [True, False])
def test_every_stage_is_a_profiler_event(record):
    """Recorded or not, each stage opens a ``record_function`` of its name,
    which names a ``torch.profiler`` session's idle gaps."""
    timer = profiling.StageTimer(record=record)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _nested(timer)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer") == names.count("inner") == 3
    assert len(timer.spans) == (6 if record else 0)


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetched_reports_the_wait_for_a_slow_prepare(depth):
    sleep = 0.2

    def prepare(x):
        time.sleep(sleep)
        return x

    waits = []
    assert list(prefetched(range(2), prepare, depth=depth, waits=waits)) == [0, 1]
    assert len(waits) == 2
    # synchronous: the prepare itself; threaded: the queue, which the first
    # item leaves empty for the whole sleep, bar the worker's start
    assert waits[0] >= (sleep if depth == 0 else 0.9 * sleep)
    assert list(prefetched(range(3), lambda x: x, depth=depth)) == [0, 1, 2]


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(1)
    for i in range(4):
        save_wav(str(d / f"c{i}.wav"), (0.1 * rng.standard_normal(SR + 2500 * i)), SR)
    return str(d)


def test_trainer_history_carries_the_wait_and_step_span(wav_dir):
    tcfg = TrainerConfig(data_path=wav_dir, run_dir="", batch_size=2, epochs=2, max_steps=4,
                         log_interval=1, save_interval=1000, mel_bucket=64, warmup_steps=1)
    tr = Trainer(port_cfg(tiny_train_cfg()), tcfg, device="cpu",
                 whisper_cfg=WhisperEncoderConfig(d_model=48, n_layers=1, n_heads=4,
                                                  ffn_dim=96))
    assert tr.train() == 4
    assert len(tr.history) == 4
    for h in tr.history:
        span = h["span"]
        assert span.name == "train.step" and h["wait_s"] >= 0
        assert span.device_s() is None  # no card
        assert 0 < span.host_s == pytest.approx((span.end_ns - span.start_ns) * 1e-9)
    spans = [h["span"] for h in tr.history]
    # each step's span closes before the loop stamps its end, and the next opens after
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    assert [h["end"] for h in tr.history] == sorted(h["end"] for h in tr.history)


@pytest.fixture(scope="module")
def converter():
    return tiny_xlsr()[1]


def _speechlike(n, f0, seed, amp=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (amp * np.sin(2 * np.pi * f0 * t) + 0.002 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("profile", [True, False])
def test_convert_reports_sample_vocode_and_euler_steps(converter, profile):
    src, ref = _speechlike(SR, 150, 1), _speechlike(SR // 2, 220, 2)
    _, wave, stats = converter.convert(src, SR, ref, SR, diffusion_steps=3, profile=profile)
    st = stats["stages"]
    n = st["sample+vocode"]["calls"]
    assert n == stats["chunks"] >= 1 and st["sample"]["calls"] == st["vocode"]["calls"] == n
    assert st["sample"]["steps"] == 3 * n
    assert all(v["device_seconds"] is None for v in st.values())  # no card
    assert st["sample+vocode"]["seconds"] >= st["sample"]["seconds"] + st["vocode"]["seconds"]
    assert len(wave) > 0


def test_eager_stream_keeps_a_record_a_block(converter):
    cfg = streaming.StreamConfig(block_time=0.1, crossfade_time=0.02, sola_search_time=0.01,
                                 extra_time_ce=0.3, extra_time_dit=0.2, extra_time_right=0.02,
                                 diffusion_steps=2, max_prompt_time=0.5)
    st = streaming.StreamingConverter(converter, cfg)
    st.set_reference(_speechlike(SR, 230, 7), SR)
    src = _speechlike(6 * st.block, 140, 8)
    src[2 * st.block:] = 0.0  # 2 speech blocks, 1 on the hangover, 3 gated
    for i in range(6):
        st.process_block(src[i * st.block:(i + 1) * st.block])
    recs = list(st.timings)
    assert [r["gated"] for r in recs] == [False] * 3 + [True] * 3
    parts = ("dispatch_ms", "sync_ms", "sola_ms", "encode_ms", "cfm_ms", "vocode_ms",
             "gate_ms", "total_ms")
    for r in recs:
        assert r["total_ms"] >= r["gate_ms"] >= 0
        if r["gated"]:
            assert set(r) == {"gated", "gate_ms", "total_ms"}
        else:
            assert set(r) == {"gated", *parts}
            assert r["encode_ms"] is r["cfm_ms"] is r["vocode_ms"] is None  # eager: no graph
            assert r["total_ms"] >= r["dispatch_ms"] + r["sync_ms"] - 0.02
    assert set(st.last_timings) == set(parts)
    assert st.last_timings["total_ms"] == recs[2]["total_ms"]
    st.timings.extend([{}] * streaming.TIMINGS_KEPT)
    assert len(st.timings) == streaming.TIMINGS_KEPT
