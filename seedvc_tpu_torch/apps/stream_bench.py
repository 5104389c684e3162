"""Real-time streaming latency benchmark on the card (port of
``seedvc_tpu/apps/stream_bench.py``).

Runs the whole block path (rings -> content encoder -> regulate -> CFM ->
vocoder -> SOLA) of the real-time model (``xlsr_tiny`` by default; random
weights: latency does not depend on them) on white-noise blocks with the VAD
gate off (the gate would reject white noise and time the skip path), after a
3 s reference, and prints each block's wall time against the block budget,
the steady-state median over blocks 3 and later, the occupancy, the split
that ``StreamingConverter.last_timings`` gives, the kernel launches one
replay of the captured block program makes, and the replays made. Runs on ``cuda`` unless
``--device cpu`` is given.

    python -m seedvc_tpu_torch.apps.stream_bench [--block-time 0.25] [--steps 10]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_converter(args):
    """The preset at full width, with the JAX benchmark's encoder rule: a
    Whisper preset whose regulator does not take Whisper-small's 768 gets a
    12-layer Whisper of its width (an SSL preset ignores ``whisper_cfg`` and
    takes XLS-R 300M at layer 12)."""
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.models.whisper import WHISPER_SMALL, WhisperEncoderConfig
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    cfg = get_preset(args.preset)
    wcfg = WHISPER_SMALL
    d = cfg.model_params.length_regulator.in_channels
    if d != wcfg.d_model:
        wcfg = WhisperEncoderConfig(d_model=d, n_layers=12, n_heads=16, ffn_dim=4 * d)
    return VoiceConverter(cfg, whisper_cfg=wcfg, device=args.device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="xlsr_tiny")
    ap.add_argument("--block-time", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--n-blocks", type=int, default=20)
    ap.add_argument("--use-whisper-small", action="store_true",
                    help="accepted as the JAX benchmark accepts it; the content "
                         "encoder follows the preset (see build_converter)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from seedvc_tpu_torch.pipelines.streaming import StreamConfig, StreamingConverter

    conv = build_converter(args)
    scfg = StreamConfig(block_time=args.block_time, diffusion_steps=args.steps,
                        vad_threshold_db=-10000.0)
    stream = StreamingConverter(conv, scfg)

    rng = np.random.default_rng(0)
    ref = (rng.standard_normal(22050 * 3) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    stream.set_reference(ref, 22050)
    set_ref_s = time.perf_counter() - t0
    print(f"set_reference: {set_ref_s:.1f}s")

    times, splits = [], []
    for i in range(args.n_blocks):
        block = (rng.standard_normal(stream.block) * 0.1).astype(np.float32)
        t0 = time.perf_counter()
        out = stream.process_block(block)
        dt = time.perf_counter() - t0
        if out.shape != (stream.block,) or not np.isfinite(out).all():
            raise RuntimeError(f"block {i}: {out.shape} output or non-finite samples")
        times.append(dt)
        splits.append(stream.last_timings)
        print(f"block {i}: {dt * 1000:.1f} ms (budget {args.block_time * 1000:.0f} ms) "
              f"{json.dumps(stream.last_timings)}")
    steady = float(np.median(times[3:])) if len(times) > 3 else float(np.median(times))
    print(f"steady-state per-block: {steady * 1000:.1f} ms for "
          f"{args.block_time * 1000:.0f} ms blocks -> "
          f"{'REALTIME OK' if steady < args.block_time else 'TOO SLOW'} "
          f"(occupancy {steady / args.block_time * 100:.0f}%)")
    delay_s = args.block_time + scfg.crossfade_time + scfg.extra_time_right
    print(f"algorithmic delay ~ {delay_s * 1000:.0f} ms + device time")
    print(f"captured launches per block: {json.dumps(stream.graph_launches)}, "
          f"replays: {stream.replays}")
    return {"block_ms": [t * 1000 for t in times], "steady_ms": steady * 1000,
            "budget_ms": args.block_time * 1000, "set_reference_s": set_ref_s,
            "timings": splits, "graph_launches": stream.graph_launches,
            "replays": stream.replays, "dit_T": stream._prompt_len + stream.dit_frames}


if __name__ == "__main__":
    main()
