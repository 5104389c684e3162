"""Arithmetic of the per-layer metrics read from the program's own spans
(``seedvc_tpu_torch/core/profiling.py``): the offline request's stages, the
stream's per-block records and the trainer's per-step history. A program
without those spans or fields gives None, and the metric is left out of the
line.
"""

from __future__ import annotations

import statistics

from vcbench.readers import synced


def _stage_sum(ds, stage: str, key: str):
    """Σ ``key`` of ``stage`` over the requests ``ds``; None if any lacks it."""
    xs = [(d.stages.get(stage) or {}).get(key) for d in ds]
    return sum(xs) if xs and None not in xs else None


def _per_step(run, key: str):
    ds = synced(run)
    total, steps = _stage_sum(ds, "sample", key), _stage_sum(ds, "sample", "steps")
    return 1e3 * total / steps if total is not None and steps else None


def sampler_host_ms_per_step(run):
    """Host ms of the ``sample`` stage (the sampler's dispatch; no
    synchronise inside it) per Euler step, over the window's synced requests."""
    return _per_step(run, "seconds")


def sampler_device_ms_per_step(run):
    """Device ms of the ``sample`` stage (its timing events) per Euler step."""
    return _per_step(run, "device_seconds")


def vocode_device_s_per_audio_s(run):
    """Device seconds of the ``vocode`` stage over the audio seconds converted."""
    ds = synced(run)
    sr = run.config["preset"]["preprocess_params"]["sr"]
    audio = sum(len(d.wave) for d in ds) / sr
    secs = _stage_sum(ds, "vocode", "device_seconds")
    return secs / audio if secs is not None and audio > 0 else None


def _window_blocks(run) -> list[dict]:
    """The stream's records of the window's converted blocks (its last
    records, as many as the window fed, at most as many as it keeps)."""
    stream, window = run.records.get("stream"), run.records.get("window")
    timings = list(getattr(stream, "timings", None) or [])
    if not window or not timings:
        return []
    return [t for t in timings[-len(window):] if not t["gated"]]


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def block_device_ms(run):
    """Median over the window's converted blocks of the graph's first to
    last timing event (encoder, CFM and vocoder parts summed)."""
    parts = ("encode_ms", "cfm_ms", "vocode_ms")
    return _median([None if any(t.get(p) is None for p in parts) else sum(t[p] for p in parts)
                    for t in _window_blocks(run)])


def encoder_device_ms(run):
    """Median device ms of the block's content encoder (rings, 16 kHz
    resampling, XLS-R)."""
    return _median([t.get("encode_ms") for t in _window_blocks(run)])


def block_host_ms(run):
    """Median host ms of a converted block outside its wait for the output:
    ``total_ms - sync_ms``."""
    return _median([t["total_ms"] - t["sync_ms"] for t in _window_blocks(run)])


def _steps_ms(run, read):
    """Median ms of ``read(history entry)`` over the window's steps, None
    where it gives None."""
    return _median([None if (s := read(h)) is None else 1e3 * s
                    for h in run.records.get("window", [])])


def queue_wait_ms(run):
    """Median wait of the trainer's loop for its next prepared batch."""
    return _steps_ms(run, lambda h: h.get("wait_s"))


def step_host_ms(run):
    """Median host wall of the step function (its span)."""
    return _steps_ms(run, lambda h: h["span"].host_s if "span" in h else None)


def step_device_ms(run):
    """Median device time from the step's first to last launch (its span's
    events, completed by the window's closing synchronise)."""
    return _steps_ms(run, lambda h: h["span"].device_s() if "span" in h else None)
