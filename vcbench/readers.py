"""Arithmetic the per-layer metric files share. Each metric file under
``metrics/`` is one ``read(run)`` that calls into here; a reader that finds
nothing to read returns None and the metric is left out of the line.
"""

from __future__ import annotations

import statistics

from vcbench import peaks, v1
from vcbench.trace import kernel_seconds

K1_BF16 = ("rope_prepass_kernel", "attn_core_kernel")
K2 = ("anti_alias_snake_kernel",)

_COUNTERS: dict = {}


def counter(run):
    """The operation counter of the run's configuration (built once)."""
    from vcbench import spec
    key = run.cell.config_name
    if key not in _COUNTERS:
        _COUNTERS[key] = spec.builder(run.config, run.cell.base).Counter(run.config)
    return _COUNTERS[key]


def idle_share(run):
    sub = run.subwindow
    if not sub or sub["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sub["busy_s"] / sub["window_s"])


def _traced_plans(run):
    """(Done, lengths, ops) of each request the profiled sub-window ran."""
    out = []
    for d in run.records.get("traced", []):
        inp = run.records["inputs"][d.req.slot]
        L = v1.lengths(run.config, run.traffic, d.req, inp)
        out.append((d, L, v1.conversion_ops(counter(run), run.config, L, d.req.steps)))
    return out


def convert_mfu(run):
    """Least time of the traced requests' operations (bf16 parts at the bf16
    peak, f32 parts at the f32 peak) over the sub-window's seconds, in %."""
    sub = run.subwindow
    plans = _traced_plans(run)
    if not sub or not plans:
        return None
    least = sum(ops["low"] / peaks.PEAK_BF16 + ops["f32"] / peaks.PEAK_F32
                for _, _, ops in plans)
    return 100.0 * least / sub["window_s"]


def k1_roofline(run):
    """Σ bound / Σ device time of K1's launches in the sub-window: each
    chunk runs depth launches a step at (2, H, context, 64), both CFG rows
    with p_len + w valid keys. None unless that count equals the program's
    own launch counter over the sub-window."""
    sub = run.subwindow
    plans = _traced_plans(run)
    if not sub or not plans:
        return None
    c = counter(run)
    n, bound = 0, 0.0
    for d, L, ops in plans:
        for n_valid in ops["n_valid"]:
            k = d.req.steps * c.depth
            n += k
            bound += k * peaks.k1_bf16(2, c.heads, ops["context"], ops["context"],
                                       2 * n_valid, c.head_dim)
    if n != run.records.get("launches", {}).get("k1"):
        run.log(f"k1_roofline: {n} launches by the plans, "
                f"{run.records.get('launches', {}).get('k1')} by the program's counter")
        return None
    secs = kernel_seconds(sub, K1_BF16)
    return 100.0 * bound / secs if secs > 0 else None


def k2_shapes(cfg: dict, frames: int) -> list[tuple[int, int, int]]:
    """BigVGAN's anti-aliased activations for ``frames`` mel frames: two a
    dilation in each resblock of each upsampling stage, and the last one."""
    voc = cfg["vocoder"]
    C, T = voc["upsample_initial_channel"], frames
    out = []
    for r in voc["upsample_rates"]:
        C, T = C // 2, T * r
        n = sum(2 * len(d) for d in voc["resblock_dilation_sizes"])
        out += [(1, C, T)] * n
    out.append((1, C, T))
    return out


def k2_roofline(run):
    sub = run.subwindow
    plans = _traced_plans(run)
    if not sub or not plans:
        return None
    n, bound = 0, 0.0
    for d, L, ops in plans:
        (_, _, W), _ = v1.plan(run.config, L)
        for _ in range(ops["chunks"]):
            shapes = k2_shapes(run.config, W)
            n += len(shapes)
            bound += sum(peaks.k2(*s) for s in shapes)
    if n != run.records.get("launches", {}).get("k2"):
        run.log(f"k2_roofline: {n} launches by the plans, "
                f"{run.records.get('launches', {}).get('k2')} by the program's counter")
        return None
    secs = kernel_seconds(sub, K2)
    return 100.0 * bound / secs if secs > 0 else None


def synced(run):
    """The finished requests that ran with device-synchronised stages."""
    return [d for d in run.records.get("synced", []) if d.wave is not None and d.stages]


def sample_vocode_per_audio_s(run):
    sr = run.config["preset"]["preprocess_params"]["sr"]
    ds = synced(run)
    audio = sum(len(d.wave) for d in ds) / sr
    if not ds or audio <= 0:
        return None
    return sum(d.stages["sample+vocode"]["seconds"] for d in ds) / audio


def block_mfu(run):
    """Least time of the traced sub-window's converted blocks' operations
    (the DiT at the bf16 peak; XLS-R, regulator, HiFT at the f32 peak) over
    the sub-window's seconds, in %."""
    sub = run.subwindow
    n = run.records.get("traced_converted")
    if not sub or not n:
        return None
    st = run.records["stream_cfg"]
    ops = counter(run).block(st, run.records["prompt_frames"])
    least = ops["low"] / peaks.PEAK_BF16 + ops["f32"] / peaks.PEAK_F32
    return 100.0 * n * least / sub["window_s"]


def block_sync_ms(run):
    """Median over the window's converted blocks of the stream's own
    ``last_timings["sync_ms"]`` (the wait for the replay and the copy out)."""
    xs = [e["sync_ms"] for e in run.records.get("window", []) if e["sync_ms"] is not None]
    return statistics.median(xs) if xs else None


K1_F32 = ("rope_prepass_f32_kernel", "attn_fwd_tf32")
K1B = ("bwd_prep_kernel", "bwd_dkdv_kernel", "bwd_finish_kernel")


def _traced_steps(run):
    """(history entry, batch, T, s_T, valid keys a row) of each traced step."""
    hist, log = run.records.get("traced", ([], []))
    hop = run.config["preset"]["preprocess_params"]["spect_params"]["hop_length"]
    bucket = run.traffic.get("trainer", {}).get("mel_bucket", 128)
    out = []
    for h, b in zip(hist, log):
        lens = b.wave_lengths // hop
        T = -(-int(lens.max()) // bucket) * bucket
        w16 = min(-(-b.waves_16k.shape[1] // 16000) * 16000, 30 * 16000)
        s_true = int(min(b.wave_16k_lengths.max(), w16)) // 320 + 1
        s_T = min(-(-s_true // 64) * 64, 1500)
        out.append((h, b, T, s_T, [int(x) for x in lens]))
    return out


def train_mfu(run):
    """Least time of the traced steps' operations over the sub-window: the
    trained model's forward and backward at the f32 peak, its attention
    (K1 f32 forward, K1ᵇ) at the 3xTF32 rate, the content encoder's windows
    in the batch preparation at the bf16 peak."""
    sub = run.subwindow
    steps = _traced_steps(run)
    if not sub or not steps:
        return None
    c = counter(run)
    least = 0.0
    for h, b, T, s_T, lens in steps:
        B = len(lens)
        attn_f = c.depth * 4.0 * c.head_dim * T * c.heads * sum(lens)
        attn_b = c.depth * 10.0 * B * c.heads * T * T * c.head_dim
        least += (c.train_step(B, T, s_T) / peaks.PEAK_F32
                  + 3 * (attn_f + attn_b) / peaks.PEAK_TF32
                  + B * c.whisper_window() / peaks.PEAK_BF16)
    return 100.0 * least / sub["window_s"]


def _train_roofline(run, key, patterns, bound_fn):
    sub = run.subwindow
    steps = _traced_steps(run)
    if not sub or not steps:
        return None
    c = counter(run)
    n = sum(h[key] for h, *_ in steps)
    bound = sum(h[key] * bound_fn(c, T, lens) for h, b, T, s_T, lens in steps)
    if n != c.depth * len(steps):
        run.log(f"{key}: {n} launches by the program's counter, {c.depth * len(steps)} "
                "by the steps")
        return None
    secs = kernel_seconds(sub, patterns)
    return 100.0 * bound / secs if secs > 0 else None


def k1f32_roofline(run):
    return _train_roofline(run, "k1", K1_F32, lambda c, T, lens: peaks.k1_f32(
        len(lens), c.heads, T, sum(lens), c.head_dim))


def k1b_roofline(run):
    return _train_roofline(run, "k1b", K1B, lambda c, T, lens: peaks.k1b_f32(
        len(lens), c.heads, T, c.head_dim))


def prep_ms(run):
    xs = [h["prep_s"] for h in run.records.get("window", [])]
    return 1e3 * statistics.median(xs) if xs else None


def step_ms(run):
    xs = run.records.get("step_s", [])
    return 1e3 * statistics.median(xs) if xs else None
