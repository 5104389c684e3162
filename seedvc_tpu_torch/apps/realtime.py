"""Real-time voice conversion CLI (port of ``seedvc_tpu/apps/realtime.py``):
drives :class:`seedvc_tpu_torch.pipelines.streaming.StreamingConverter`
either

- **live** from an audio device (needs the optional ``sounddevice``
  package, imported only in live mode), or
- **simulated** from a wav file (``--simulate``), feeding fixed-size blocks
  as the device callback would, optionally paced at real time, and reporting
  the inference time per block, the occupancy and the algorithmic delay.

Settings persist to ``configs/inuse/realtime.json`` under the working
directory between runs. Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m seedvc_tpu_torch.apps.realtime --reference ref.wav \
        --simulate input.wav --output out.wav --block-time 0.25
    python -m seedvc_tpu_torch.apps.realtime --reference ref.wav \
        --input-device 1 --output-device 3   # live (needs sounddevice)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from seedvc_tpu_torch.core.utils import str2bool

SETTINGS_PATH = os.path.join("configs", "inuse", "realtime.json")
SETTING_KEYS = ("preset", "block_time", "crossfade_time", "extra_time_ce",
                "extra_time_dit", "extra_time_right", "diffusion_steps",
                "cfg_rate", "max_prompt_time", "vad_threshold_db")


def load_settings(path: str = SETTINGS_PATH) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_settings(values: dict, path: str = SETTINGS_PATH) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({k: values[k] for k in SETTING_KEYS if k in values}, f, indent=2)


def build_streamer(args, params: dict):
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    from seedvc_tpu_torch.pipelines.streaming import StreamConfig, StreamingConverter

    converter = VoiceConverter(get_preset(args.preset), device=args.device, **params)
    scfg = StreamConfig(
        block_time=args.block_time, crossfade_time=args.crossfade_time,
        extra_time_ce=args.extra_time_ce, extra_time_dit=args.extra_time_dit,
        extra_time_right=args.extra_time_right, diffusion_steps=args.diffusion_steps,
        cfg_rate=args.cfg_rate, max_prompt_time=args.max_prompt_time,
        vad_threshold_db=args.vad_threshold_db)
    return StreamingConverter(converter, scfg)


def algorithmic_delay_ms(streamer) -> float:
    # block * 2 + extra_right, the reference's published formula
    return 1000.0 * (2 * streamer.block + streamer.extra_right) / streamer.sr


def run_simulated(streamer, args) -> dict:
    import numpy as np
    import torch

    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
    from seedvc_tpu_torch.dsp.resample import resample

    wave, sr = load_wav(args.simulate)
    wave = resample(torch.from_numpy(wave), sr, streamer.sr).numpy()
    block = streamer.block
    n_blocks = max(-(-len(wave) // block), 1)  # ceil: pad the last block
    wave = np.pad(wave, (0, n_blocks * block - len(wave)))

    block_s = block / streamer.sr
    out_blocks, times = [], []
    for i in range(n_blocks):
        t0 = time.perf_counter()
        out_blocks.append(streamer.process_block(wave[i * block:(i + 1) * block]))
        dt = time.perf_counter() - t0
        times.append(dt)
        if args.realtime_pace and dt < block_s:
            time.sleep(block_s - dt)

    out = np.concatenate(out_blocks)
    if args.output:
        save_wav(args.output, out, streamer.sr)
        print(f"saved: {args.output}")

    warm = times[1:] if len(times) > 1 else times
    report = {
        "blocks": n_blocks,
        "block_ms": round(block_s * 1000, 1),
        "infer_ms_mean": round(1000 * sum(warm) / len(warm), 1),
        "infer_ms_max": round(1000 * max(warm), 1),
        "occupancy": round(sum(warm) / len(warm) / block_s, 3),
        "algorithmic_delay_ms": round(algorithmic_delay_ms(streamer), 1),
        "realtime_ok": max(warm) < block_s,
    }
    print(json.dumps(report))
    return report


def run_live(streamer, args) -> None:  # pragma: no cover - needs audio hardware
    try:
        import sounddevice as sd
    except ImportError:
        sys.exit("live mode requires the optional 'sounddevice' package; "
                 "use --simulate <wav> for file-driven streaming instead")
    import numpy as np

    block = streamer.block
    infer_ms = [0.0]

    def callback(indata, outdata, frames, time_info, status):
        if status:
            print(status, file=sys.stderr)
        t0 = time.perf_counter()
        out = streamer.process_block(indata.mean(axis=1).astype(np.float32))
        outdata[:] = out[:, None]
        infer_ms[0] = (time.perf_counter() - t0) * 1000

    with sd.Stream(samplerate=streamer.sr, blocksize=block,
                   device=(args.input_device, args.output_device),
                   channels=1, dtype="float32", callback=callback):
        print(f"streaming at {streamer.sr} Hz, block {block} samples "
              f"({block / streamer.sr * 1000:.0f} ms); "
              f"algorithmic delay {algorithmic_delay_ms(streamer):.0f} ms; "
              "Ctrl-C to stop")
        try:
            while True:
                time.sleep(1.0)
                print(f"\rinfer {infer_ms[0]:6.1f} ms", end="", flush=True)
        except KeyboardInterrupt:
            print()


def main(argv=None):
    saved = load_settings()
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch real-time VC")
    ap.add_argument("--reference", required=True, help="reference voice wav")
    ap.add_argument("--preset", default=saved.get("preset", "xlsr_tiny"))
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--simulate", help="input wav: file-driven streaming")
    ap.add_argument("--output", help="output wav (simulate mode)")
    ap.add_argument("--realtime-pace", type=str2bool, default=False,
                    help="simulate mode: sleep to pace blocks at real time")
    ap.add_argument("--input-device", type=int, default=None)
    ap.add_argument("--output-device", type=int, default=None)
    ap.add_argument("--list-devices", action="store_true")
    ap.add_argument("--block-time", type=float, default=saved.get("block_time", 0.25))
    ap.add_argument("--crossfade-time", type=float, default=saved.get("crossfade_time", 0.04))
    ap.add_argument("--extra-time-ce", type=float, default=saved.get("extra_time_ce", 2.5))
    ap.add_argument("--extra-time-dit", type=float, default=saved.get("extra_time_dit", 0.5))
    ap.add_argument("--extra-time-right", type=float,
                    default=saved.get("extra_time_right", 0.02))
    ap.add_argument("--diffusion-steps", type=int, default=saved.get("diffusion_steps", 10))
    ap.add_argument("--cfg-rate", type=float, default=saved.get("cfg_rate", 0.7))
    ap.add_argument("--max-prompt-time", type=float, default=saved.get("max_prompt_time", 3.0))
    ap.add_argument("--vad-threshold-db", type=float,
                    default=saved.get("vad_threshold_db", -60.0))
    ap.add_argument("--save-settings", type=str2bool, default=True)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.list_devices:
        try:
            import sounddevice as sd
            print(sd.query_devices())
        except ImportError:
            print("sounddevice not installed; live mode unavailable "
                  "(simulate mode works without it)")
        return None

    from seedvc_tpu_torch.apps.audio_io import load_wav
    from seedvc_tpu_torch.pipelines.wrapper import load_params_dir

    params = load_params_dir(args.checkpoint_dir)
    if not params:
        print("[warn] no --checkpoint-dir: RANDOM weights (latency smoke mode)",
              file=sys.stderr)
    streamer = build_streamer(args, params)
    ref, ref_sr = load_wav(args.reference)
    streamer.set_reference(ref, ref_sr)
    if args.save_settings:
        save_settings(vars(args))
    if args.simulate:
        return run_simulated(streamer, args)
    run_live(streamer, args)
    return None


if __name__ == "__main__":
    main()
