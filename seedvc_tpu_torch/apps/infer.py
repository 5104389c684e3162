"""Offline voice conversion CLI (port of ``seedvc_tpu/apps/infer.py``):

    python -m seedvc_tpu_torch.apps.infer --source a.wav --target ref.wav \
        --output out/ --diffusion-steps 25 --inference-cfg-rate 0.7
    python -m seedvc_tpu_torch.apps.infer --source song.wav --target ref.wav \
        --f0-condition true --auto-f0-adjust true --semi-tone-shift 2

Runs on ``cuda`` unless ``--device cpu`` is given. Without converted
checkpoints (``--checkpoint-dir``) the models run with random weights: useful
for latency and throughput smoke runs only.
"""

from __future__ import annotations

import argparse
import os
import sys

from seedvc_tpu_torch.core.utils import str2bool


def main(argv=None):
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch offline VC")
    ap.add_argument("--source", help="source wav (or use --source-dir)")
    ap.add_argument("--source-dir", help="batch mode: convert every audio file in this directory")
    ap.add_argument("--target", required=True, help="reference voice wav")
    ap.add_argument("--output", default="./out")
    ap.add_argument("--preset", default="whisper_small_wavenet")
    ap.add_argument("--diffusion-steps", type=int, default=25)
    ap.add_argument("--length-adjust", type=float, default=1.0)
    ap.add_argument("--f0-condition", type=str2bool, default=False,
                    help="SVC mode: the F0-conditioned 44.1 kHz model (selects the "
                         "whisper_base_f0_44k preset unless --preset is already "
                         "F0-conditioned)")
    ap.add_argument("--auto-f0-adjust", type=str2bool, default=False,
                    help="match the source's median log-F0 to the reference's")
    ap.add_argument("--semi-tone-shift", type=float, default=0.0,
                    help="pitch shift in semitones applied to voiced frames")
    ap.add_argument("--inference-cfg-rate", type=float, default=0.7)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory with converted .pkl parameter trees")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage times (each stage ends in a device synchronise)")
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16", "float32"),
                    help="sampler + content-encoder compute dtype (default: bfloat16 "
                         "on cuda, float32 on cpu)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav, scan_audio_files
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    from seedvc_tpu_torch.pipelines.wrapper import load_params_dir

    cfg = get_preset(args.preset)
    if args.f0_condition and not cfg.model_params.DiT.f0_condition:
        print(f"[info] --f0-condition: preset {args.preset!r} is not "
              "F0-conditioned, using 'whisper_base_f0_44k'", file=sys.stderr)
        args.preset = "whisper_base_f0_44k"
        cfg = get_preset(args.preset)

    params = load_params_dir(args.checkpoint_dir)
    if not args.checkpoint_dir:
        print("[warn] no --checkpoint-dir: running with RANDOM weights "
              "(smoke/perf mode)", file=sys.stderr)
    if args.compute_dtype:
        params["compute_dtype"] = getattr(torch, args.compute_dtype)
    converter = VoiceConverter(cfg, seed=args.seed, device=args.device, **params)

    if args.source_dir:
        sources = scan_audio_files(args.source_dir)
    elif args.source:
        sources = [args.source]
    else:
        ap.error("one of --source / --source-dir is required")

    ref, ref_sr = load_wav(args.target)
    ref_name = os.path.splitext(os.path.basename(args.target))[0]
    os.makedirs(args.output, exist_ok=True)
    for source in sources:
        src, src_sr = load_wav(source)
        sr, wave, stats = converter.convert(
            src, src_sr, ref, ref_sr, diffusion_steps=args.diffusion_steps,
            length_adjust=args.length_adjust, cfg_rate=args.inference_cfg_rate,
            auto_f0_adjust=args.auto_f0_adjust, pitch_shift=args.semi_tone_shift,
            seed=args.seed, profile=args.profile)
        if args.profile:
            for stage, rec in stats["stages"].items():
                print(f"  {stage:<10} {rec['seconds']:7.3f}s ({rec['calls']} calls)")
        src_name = os.path.splitext(os.path.basename(source))[0]
        out_path = os.path.join(
            args.output, f"vc_{src_name}_{ref_name}_{args.length_adjust}"
            f"_{args.diffusion_steps}_{args.inference_cfg_rate}.wav")
        save_wav(out_path, wave, sr)
        print(f"RTF: {stats['rtf']:.4f}  ({stats['audio_seconds']:.2f}s audio "
              f"in {stats['wall_seconds']:.2f}s, {stats['chunks']} chunks)")
        print(f"saved: {out_path}")


if __name__ == "__main__":
    main()
