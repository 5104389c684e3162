"""Arithmetic of the SVC cell's per-layer metrics that v1's readers do not
already give. Each file ``metrics/<name>.svc.py`` is one ``read(run)``
calling into here or into ``readers.py`` / ``spans.py``; a reader that
finds nothing to read (a program without the ``f0`` spans or counters)
returns None and the metric is left out of the line."""

from __future__ import annotations

from vcbench import peaks, svc, v1
from vcbench.readers import counter, synced
from vcbench.spans import _stage_sum as _sum


def _audio_s(run, ds) -> float:
    return sum(len(d.wave) for d in ds) / run.config["preset"]["preprocess_params"]["sr"]


def f0_s_per_audio_s(run):
    """Seconds of the ``f0`` stage (RMVPE on source and reference, the
    decode) over the output audio seconds, over the window's synced
    requests."""
    ds = synced(run)
    secs, audio = _sum(ds, "f0", "seconds"), _audio_s(run, ds)
    return secs / audio if secs is not None and audio > 0 else None


def f0_gru_us_per_step(run):
    """Device microseconds of the ``f0.gru`` spans per GRU step (both
    scans' steps, counted by the span)."""
    ds = synced(run)
    secs, steps = _sum(ds, "f0.gru", "device_seconds"), _sum(ds, "f0.gru", "gru_steps")
    return 1e6 * secs / steps if secs is not None and steps else None


def convert_mfu(run):
    """Least time of the traced requests' operations (Whisper and the DiT at
    the bf16 peak; RMVPE, CAMPPlus, the regulator and BigVGAN at the f32
    peak) over the sub-window's seconds, in %."""
    sub = run.subwindow
    traced = run.records.get("traced", [])
    if not sub or not traced or sub["window_s"] <= 0:
        return None
    least = 0.0
    for d in traced:
        L = v1.lengths(run.config, run.traffic, d.req, run.records["inputs"][d.req.slot])
        ops = svc.conversion_ops(counter(run), run.config, L, d.req.steps)
        least += ops["low"] / peaks.PEAK_BF16 + ops["f32"] / peaks.PEAK_F32
    return 100.0 * least / sub["window_s"]
