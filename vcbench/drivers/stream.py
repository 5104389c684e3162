"""The live voice changer: one stream through
``StreamingConverter.process_block``, blocks fed back to back.

One stream never queues (a block takes a tenth of its budget), so a
block's latency is its service time, and feeding blocks back to back puts a
thousand and more of them into a window. ``block_p99_ms``: the 99th
percentile, over every block of the window, of the wall from handing the
block to ``process_block`` to its return. The source is seeded speech-like
audio (talk spurts and pauses, so the voice gate skips some blocks), looped.
With ``--trace 1`` the first ``trace.blocks`` blocks run under the profiler
before the window opens.

The check, in stretches of consecutive blocks: the first from the run's
first converted block on, the others drawn from the seed among the window's,
each starting at a converted block right after a gated one. The frozen
reference (its voice gate, its eager f32 block program, its numpy SOLA)
takes the same input history, noise and draws; the rings are a function of
the input alone, so it rebuilds them from the blocks before a stretch, and
a gated block leaves no hangover and a tail of zeros, so it starts a
stretch from that state. Three numbers: ``gate_mismatches``, the blocks the
two gates decide differently; ``block_rel_err``, the block program's output
spans against the reference's (pooled); ``join_rel_err``, the emitted blocks
against the reference's SOLA run over the program's own output spans,
carrying its own tail from a stretch's start (pooled). SOLA's offset is an
argmax over near-equal correlations, so it is checked on the program's
spans: on the reference's it would flip with bf16 rounding. The one thing
taken from the program's run besides its outputs is the noise key of a
stretch's first block (how many blocks the program converted before it).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from vcbench import stats, traffic as T
from vcbench.audio import speech_like
from vcbench.trace import SubWindow


def stream_config(cls, tr: dict):
    return cls(**tr.get("stream", {}))


def _noise(seed: int, k: int, shape, device):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * k + 1) % (2 ** 63))
    return torch.randn(shape, generator=g, device=device)


def _noise_from(seed: int, k0: int, device):
    """A ``noise_fn`` whose calls take the noise keys k0, k0 + 1, ..."""
    keys = iter(range(k0, 1 << 62))
    return lambda shape: _noise(seed, next(keys), shape, device)


def _draws(seed: int, device):
    def draws_fn(shape):
        B, n, H = shape
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) * 1_000_003 + 2) % (2 ** 63))
        phase = (torch.rand((B, 1, H), generator=g, device=device) * 2 - 1) * math.pi
        return phase, torch.randn((B, n, H), generator=g, device=device)
    return draws_fn


class Source:
    """The looped source audio, cut into blocks by index."""

    def __init__(self, tr: dict, seed: int, sr: int, block: int):
        s = tr["source"]
        self.audio = speech_like(float(s["seconds"]), sr, T.rng(seed, 2, 0),
                                 spurt=tuple(s["spurt_seconds"]), pause=tuple(s["pause_seconds"]))
        self.block = block

    def __call__(self, i: int) -> np.ndarray:
        n = len(self.audio)
        a = (i * self.block) % n
        idx = (np.arange(self.block) + a) % n
        return self.audio[idx]


def setup(run, builder):
    from seedvc_tpu_torch.pipelines.streaming import StreamConfig, StreamingConverter
    tr, dev = run.traffic, run.device
    conv = builder.program(run.config, dev)
    builder.fill(conv, run.config, run.seed, dev)
    state = {"k": 0, "log": []}

    def noise_fn(shape):
        state["k"] += 1
        return _noise(run.seed, state["k"] - 1, shape, dev)

    stream = StreamingConverter(conv, stream_config(StreamConfig, tr), noise_fn=noise_fn,
                                draws_fn=_draws(run.seed, dev))
    sr = conv.sr
    ref = speech_like(float(tr["reference_seconds"]), sr, T.rng(run.seed, 3, 0),
                      start_voiced=True, spurt=(60.0, 60.0))
    stream.set_reference(ref, sr)
    state.update(conv=conv, stream=stream, ref=ref, sr=sr,
                 source=Source(tr, run.seed, sr, stream.block), next=0)
    for _ in range(int(tr.get("warm_blocks", 8))):
        _feed(state)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.records["stream_cfg"] = stream.cfg
    run.records["prompt_frames"] = stream._prompt_len
    run.log(f"stream: block {stream.block} samples, DiT T = "
            f"{stream._prompt_len + stream.dit_frames}, graph launches {stream.graph_launches}")
    return state


def _feed(state) -> float:
    """Hand the next block to the stream; returns the wall seconds."""
    st = state["stream"]
    i = state["next"]
    block = state["source"](i)
    k = state["k"]
    t0 = time.perf_counter()
    out = st.process_block(block)
    dt = time.perf_counter() - t0
    converted = state["k"] > k
    # the block program's output span, which SOLA aligned (the next block rewrites it)
    raw = st._buf["out"].to("cpu", copy=True).numpy() if converted else None
    state["log"].append({"i": i, "k": k if converted else None, "out": out, "raw": raw,
                         "sync_ms": st.last_timings["sync_ms"] if converted else None,
                         "dt": dt})
    state["next"] = i + 1
    return dt


def window(run, state):
    tr = run.traffic
    if run.trace:
        n = int(tr.get("trace", {}).get("blocks", 40))
        with SubWindow(run.device) as sw:
            with torch.profiler.record_function("vcbench.window"):
                first = len(state["log"])
                for _ in range(n):
                    with torch.profiler.record_function("vcbench.block"):
                        _feed(state)
        run.subwindow = sw.result
        run.records["traced_converted"] = sum(e["k"] is not None
                                              for e in state["log"][first:])
    start = len(state["log"])
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        _feed(state)
    state["window"] = state["log"][start:]
    w = state["window"]
    conv = [e for e in w if e["k"] is not None]
    run.records["window"] = w
    run.records["stream"] = state["stream"]
    run.log(f"window: {len(w)} blocks, {len(conv)} converted "
            f"({100 * len(conv) / max(len(w), 1):.0f}%), "
            f"median {1e3 * stats.median([e['dt'] for e in w]):.2f} ms")


def end_to_end(run, state):
    return {"block_p99_ms": 1e3 * stats.percentile([e["dt"] for e in state["window"]], 99)}


def counts(run, state):
    return len(state["window"]), 0


def picks(state, runs: int, length: int, seed: int) -> list[list[dict]]:
    """``length`` blocks from the run's first converted one, then ``runs``
    stretches of ``length`` window blocks drawn from the seed, each starting
    at a converted block whose predecessor was gated."""
    log = state["log"]
    f = next(j for j, e in enumerate(log) if e["k"] is not None)
    w = state["window"]
    starts = [j for j in range(1, len(w) - length + 1)
              if w[j]["k"] is not None and w[j - 1]["k"] is None and w[j]["i"] >= f + length]
    chosen = sorted(T.rng(seed, 4).permutation(len(starts))[:runs])
    return [log[f: f + length]] + [w[starts[c]: starts[c] + length] for c in chosen]


def _reference_stream(run, state, builder):
    from vcbench.ref.pipelines import streaming as ref_streaming
    dev = run.device
    ref_conv = builder.reference(run.config, dev)
    builder.fill(ref_conv, run.config, run.seed, dev)
    rs = ref_streaming.StreamingConverter(
        ref_conv, stream_config(ref_streaming.StreamConfig, run.traffic),
        draws_fn=_draws(run.seed, dev))
    rs.set_reference(state["ref"], state["sr"])
    return rs


def _start(rs, state, stretch: list[dict]) -> None:
    """The reference at a stretch's start: rings rebuilt from the blocks
    before it, no hangover."""
    b, i0 = rs._buf, stretch[0]["i"]
    K = -(-rs.window // rs.block) + 1
    b["ring"].zero_()
    b["ring16"].zero_()
    for j in range(max(0, i0 - K), i0):
        b["block"].copy_(torch.from_numpy(state["source"](j)))
        rs._shift_rings()
    rs._vad_hang = 0


def reference_blocks(run, state, stretches, builder, quantised=False) -> tuple[list, list]:
    """The frozen reference over each stretch: its block-program output span
    for each block (None where its gate skips the block), and its SOLA over
    the program's output spans, carrying its own tail (none for the first
    stretch, a gated block's zeros for the others). ``quantised``: its bf16
    parts at fp8 (the control)."""
    from vcbench import control
    from vcbench.ref.pipelines import streaming as ref_streaming
    rs = _reference_stream(run, state, builder)
    sampler = ref_streaming.euler_solve
    hooks = []
    if quantised:
        hooks = control.fp8(rs.vc.vc.cfm.estimator)
        ref_streaming.euler_solve = control.euler_solve_fp8
    spans, joins = [], []
    try:
        for n, stretch in enumerate(stretches):
            _start(rs, state, stretch)
            rs.noise_fn = _noise_from(run.seed, stretch[0]["k"], run.device)
            spans.append([rs.convert_block(state["source"](e["i"])) for e in stretch])
            rs.sola.tail = None if n == 0 else np.zeros(rs.crossfade, np.float32)
            joins.append([rs.sola(e["raw"]) for e in stretch])
    finally:
        ref_streaming.euler_solve = sampler
        for h in hooks:
            h.remove()
    return spans, joins


def readings(stretches, refs, joins) -> dict:
    """gate_mismatches, block_rel_err and join_rel_err (see the module)."""
    flat = [e for s in stretches for e in s]
    ref_raw = [r for s in refs for r in s]
    both = [(e["raw"], r) for e, r in zip(flat, ref_raw) if e["raw"] is not None and r is not None]
    return {"gate_mismatches": float(sum((e["raw"] is None) != (r is None)
                                         for e, r in zip(flat, ref_raw))),
            "block_rel_err": pooled_rel_err([a for a, _ in both], [b for _, b in both]),
            "join_rel_err": pooled_rel_err([e["out"] for e in flat],
                                           [j for s in joins for j in s])}


def pooled_rel_err(outs, refs) -> float:
    num = sum(float(np.sum((a.astype(np.float64) - b) ** 2)) for a, b in zip(outs, refs))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in refs)
    return math.sqrt(num / max(den, 1e-30)) if refs else math.inf


CHECKED = ("gate_mismatches", "block_rel_err", "join_rel_err")


def check(run, state, builder):
    spec = run.traffic["check"]
    stretches = picks(state, int(spec["runs"]), int(spec["run_blocks"]), run.seed)
    state.pop("stream")
    state.pop("conv")
    run.records.pop("stream", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = readings(stretches, *reference_blocks(run, state, stretches, builder))
    run.log(f"reference over {len(stretches)} stretches, "
            f"{sum(len(s) for s in stretches)} blocks, in {time.perf_counter() - t0:.1f} s")
    return {k: (got[k], float(spec["limit"][k])) for k in CHECKED}
