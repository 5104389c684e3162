"""v2 fine-tuning CLI, port of ``seedvc_tpu/apps/train_v2.py``: the AR accent
model and/or the CFM decoder over BSQ content tokens.

    python -m seedvc_tpu_torch.apps.train_v2 --dataset-dir ./my_voice \
        --run-name v2run --max-steps 1000 --train-ar true --train-cfm true

Runs on ``cuda`` unless ``--device cpu`` is given (and raises without a card).
Checkpoints go to ``./runs/<run-name>``; a run there resumes from its newest
checkpoint. ``--checkpoint-dir`` may hold the frozen encoders as flax
pickles (``ssl.pkl``, ``narrow.pkl``, ``wide.pkl``, ``campplus.pkl``); the
rest start from random weights.

Several GPUs, one process each, under ``torchrun`` (as ``apps.train``):
``--n-model`` ranks split the DiT's and the AR's attention heads and the
DiT's FFN, the rest split the batch, and ``--fsdp`` scatters the parameters
and AdamW moments over the data ranks.
"""

from __future__ import annotations

import argparse
import os
import pickle

from seedvc_tpu_torch.core.utils import str2bool

FROZEN = ("ssl", "narrow", "wide", "campplus")


def main(argv=None, vcfg=None):
    """Train; returns the ``TrainerV2`` (its ``history`` holds one record a
    step). ``vcfg`` replaces the model configuration (``V2Config()``)."""
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch v2 fine-tuning")
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--run-name", default="v2run")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--max-steps", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--base-lr", type=float, default=1e-4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--grad-clip", type=float, default=1000.0)
    ap.add_argument("--train-ar", type=str2bool, default=True)
    ap.add_argument("--train-cfm", type=str2bool, default=True)
    ap.add_argument("--save-interval", type=int, default=500)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="converted frozen-encoder .pkl trees (ssl/narrow/wide/campplus)")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel width of the device mesh")
    ap.add_argument("--fsdp", action="store_true",
                    help="scatter params/optimizer moments over the data axis")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from seedvc_tpu_torch.parallel.distributed import initialize
    from seedvc_tpu_torch.pipelines.convert_v2 import V2Config
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.trainer_v2 import TrainerV2, TrainerV2Config

    initialize(device=args.device)  # a no-op outside a launcher
    frozen = {}
    if args.checkpoint_dir:
        for name in FROZEN:
            path = os.path.join(args.checkpoint_dir, f"{name}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    frozen[name] = pickle.load(f)
    vcfg = vcfg or V2Config()
    tcfg = TrainerV2Config(
        batch_size=args.batch_size, max_steps=args.max_steps, epochs=args.epochs,
        base_lr=args.base_lr, warmup_steps=args.warmup_steps, grad_clip=args.grad_clip,
        train_ar=args.train_ar, train_cfm=args.train_cfm, run_dir=f"./runs/{args.run_name}",
        save_interval=args.save_interval, log_interval=args.log_interval, fsdp=args.fsdp)
    trainer = TrainerV2(vcfg, tcfg, frozen_params=frozen or None, n_model=args.n_model,
                        device=args.device)
    if trainer.restore_latest():
        print(f"resumed from step {trainer.state.step}", flush=True)
    dataset = FTDataset(args.dataset_dir, vcfg.sr, args.batch_size)
    final = trainer.train(dataset)
    print(f"done at step {final}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
