"""v2 voice/accent conversion CLI (port of ``seedvc_tpu/apps/infer_v2.py``):

    python -m seedvc_tpu_torch.apps.infer_v2 --source a.wav --target ref.wav \
        --output out/ --diffusion-steps 30 --convert-style true

Runs on ``cuda`` unless ``--device cpu`` is given. ``--checkpoint-dir``
holds the converted parameter trees as ``<name>.pkl`` for the names in
``VoiceConverterV2.PARAM_NAMES``; without it the models run with random
weights: useful for latency and throughput smoke runs only.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

from seedvc_tpu_torch.core.utils import str2bool
from seedvc_tpu_torch.pipelines.convert_v2 import V2Config, VoiceConverterV2


def load_v2_params(checkpoint_dir) -> dict:
    """The ``<name>.pkl`` trees found in ``checkpoint_dir``, by name; a
    missing file leaves that module's weights random."""
    params = {}
    if checkpoint_dir:
        for name in VoiceConverterV2.PARAM_NAMES:
            path = os.path.join(checkpoint_dir, f"{name}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    params[name] = pickle.load(f)
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch v2 voice/accent conversion")
    ap.add_argument("--source", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--output", default="./out_v2")
    ap.add_argument("--diffusion-steps", type=int, default=30)
    ap.add_argument("--length-adjust", type=float, default=1.0)
    ap.add_argument("--intelligibility-cfg-rate", type=float, default=0.7)
    ap.add_argument("--similarity-cfg-rate", type=float, default=0.7)
    ap.add_argument("--convert-style", type=str2bool, default=True)
    ap.add_argument("--anonymization-only", type=str2bool, default=False)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav

    params = load_v2_params(args.checkpoint_dir)
    if not args.checkpoint_dir:
        print("[warn] no --checkpoint-dir: RANDOM weights (smoke/perf mode)", file=sys.stderr)
    converter = VoiceConverterV2(V2Config(), params=params or None, device=args.device)

    src, src_sr = load_wav(args.source)
    ref, ref_sr = load_wav(args.target)
    sr, wave, stats = converter.convert_voice(
        src, src_sr, ref, ref_sr, convert_style=args.convert_style,
        anonymization_only=args.anonymization_only, diffusion_steps=args.diffusion_steps,
        length_adjust=args.length_adjust,
        intelligibility_cfg_rate=args.intelligibility_cfg_rate,
        similarity_cfg_rate=args.similarity_cfg_rate, top_p=args.top_p,
        temperature=args.temperature, repetition_penalty=args.repetition_penalty)

    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(
        args.output, f"vc_v2_{os.path.basename(args.source).split('.')[0]}_"
        f"{os.path.basename(args.target).split('.')[0]}.wav")
    save_wav(out_path, wave, sr)
    print(f"RTF: {stats['rtf']:.4f}  wide_tokens={stats['wide_tokens']}")
    print(f"saved: {out_path}")
    return out_path, stats


if __name__ == "__main__":
    main()
