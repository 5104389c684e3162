"""Arithmetic of the v2 cell's per-layer metrics. Each file
``metrics/<name>.v2.py`` is one ``read(run)`` calling into here; a reader
that finds nothing to read (a program without the spans or counters it
reads) returns None and the metric is left out of the line."""

from __future__ import annotations

from vcbench import peaks, v2
from vcbench.readers import K1_BF16, K2, counter, k2_shapes
from vcbench.trace import kernel_seconds


def _traced_ops(run):
    """The operations of each request of the profiled sub-window."""
    inputs = run.records.get("inputs", {})
    return [v2.conversion_ops(counter(run), run.config, run.traffic, inputs[d.req.slot], d)
            for d in run.records.get("traced", []) if d.info is not None]


def convert_mfu(run):
    """Least time of the traced requests' operations (bf16 parts at the bf16
    peak, f32 parts at the f32 peak) over the sub-window's seconds, in %."""
    sub, ops = run.subwindow, _traced_ops(run)
    if not sub or not ops or sub["window_s"] <= 0:
        return None
    least = sum(o["low"] / peaks.PEAK_BF16 + o["f32"] / peaks.PEAK_F32 for o in ops)
    return 100.0 * least / sub["window_s"]


def k1_roofline(run):
    """Σ bound / Σ device time of K1's launches in the sub-window, each
    chunk's steps x depth launches at (3, H, context + 2, 64); None unless
    that count equals the program's own launch counter."""
    sub, ops = run.subwindow, _traced_ops(run)
    if not sub or not ops:
        return None
    n = sum(o["k1_launches"] for o in ops)
    if n != run.records.get("launches", {}).get("k1"):
        run.log(f"k1_roofline.v2: {n} launches by the plans, "
                f"{run.records.get('launches', {}).get('k1')} by the program's counter")
        return None
    secs = kernel_seconds(sub, K1_BF16)
    return 100.0 * sum(o["k1_bound_s"] for o in ops) / secs if secs > 0 else None


def k2_roofline(run):
    """Σ bound / Σ device time of K2's launches in the sub-window, each
    chunk's vocoder over its W frames by v1's rule (``readers.k2_shapes``);
    None unless that count equals the program's own launch counter."""
    sub = run.subwindow
    traced = [d for d in run.records.get("traced", []) if d.info is not None]
    if not sub or not traced:
        return None
    n, bound = 0, 0.0
    for d in traced:
        W = d.info["plan"][2]
        for _ in v2.chunk_widths(d.info["target_len"], W):
            shapes = k2_shapes(run.config, W)
            n += len(shapes)
            bound += sum(peaks.k2(*s) for s in shapes)
    if n != run.records.get("launches", {}).get("k2"):
        run.log(f"k2_roofline.v2: {n} launches by the plans, "
                f"{run.records.get('launches', {}).get('k2')} by the program's counter")
        return None
    secs = kernel_seconds(sub, K2)
    return 100.0 * bound / secs if secs > 0 else None


def _synced(run):
    return [d for d in run.records.get("synced", []) if d.wave is not None and d.stages]


def _sum(ds, stage: str, key: str):
    """Σ ``key`` of ``stage`` over ``ds``; None if any request lacks it."""
    xs = [(d.stages.get(stage) or {}).get(key) for d in ds]
    return sum(xs) if xs and None not in xs else None


def _audio_s(run, ds) -> float:
    return sum(len(d.wave) for d in ds) / run.config["v2"]["sr"]


def _per_step(run, stage: str, key: str):
    ds = _synced(run)
    total, steps = _sum(ds, stage, key), _sum(ds, stage, "steps")
    return 1e3 * total / steps if total is not None and steps else None


def ar_step_device_ms(run):
    """Device ms of the ``ar.decode`` span per decode step."""
    return _per_step(run, "ar.decode", "device_seconds")


def sampler_host_ms_per_step(run):
    return _per_step(run, "sample", "seconds")


def sampler_device_ms_per_step(run):
    return _per_step(run, "sample", "device_seconds")


def ar_s_per_audio_s(run):
    """Seconds of the ``ar`` span over the output audio seconds."""
    ds = _synced(run)
    secs, audio = _sum(ds, "ar", "seconds"), _audio_s(run, ds)
    return secs / audio if secs is not None and audio > 0 else None


def vocode_device_s_per_audio_s(run):
    """Device seconds of the ``vocode`` spans over the output audio seconds."""
    ds = _synced(run)
    secs, audio = _sum(ds, "vocode", "device_seconds"), _audio_s(run, ds)
    return secs / audio if secs is not None and audio > 0 else None


def ar_decode_roofline(run):
    """The decode steps' least seconds by bytes (the AR's weights and the K
    and V slots each step attends in every row) over their device seconds."""
    ds = [d for d in _synced(run) if d.info.get("rows") is not None]
    secs = _sum(ds, "ar.decode", "device_seconds")
    steps = _sum(ds, "ar.decode", "steps")
    if not ds or not secs or not steps:
        return None
    c = counter(run)
    bound = 0.0
    for d in ds:
        lens = v2.ar_lengths(d.info)
        for s in range(1, int(d.stages["ar.decode"]["steps"]) + 1):
            bound += c.ar_step_bytes(len(lens), sum(L + s for L in lens)) / peaks.PEAK_BYTES
    return 100.0 * bound / secs
