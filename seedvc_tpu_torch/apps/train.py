"""Fine-tuning CLI (v1), port of ``seedvc_tpu/apps/train.py``:

    python -m seedvc_tpu_torch.apps.train --dataset-dir ./my_voice \
        --run-name my_run --max-steps 1000 --batch-size 2

Runs on ``cuda`` unless ``--device cpu`` is given (and raises without a card).
Checkpoints go to ``./runs/<run-name>``; a run there resumes from its newest
checkpoint. The final weights are written as ``vc.pkl`` (``--export-dir``),
a flax-layout tree that ``apps.infer --checkpoint-dir`` loads. An
``openvoice.pkl`` in ``--checkpoint-dir`` (the converter's flax tree, as
``python -m seedvc_tpu_torch.apps.convert_checkpoint --openvoice`` writes
it) turns on the OpenVoice timbre perturbation, and a ``se_db.pkl`` beside it
(an (N, 256) array of speaker embeddings) gives its target voices; without
the bank the batch's own voices are shuffled. Multi-GPU (``--n-model``
other than 1, ``--fsdp``) is not ported: ROADMAP queue 1 item 3c.
"""

from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    """Train; returns the ``Trainer`` (its ``history`` holds one record a step)."""
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch fine-tuning")
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--run-name", default="run1")
    ap.add_argument("--preset", default="whisper_small_wavenet")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--max-steps", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--base-lr", type=float, default=1e-4)
    ap.add_argument("--save-interval", type=int, default=500)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory of converted .pkl trees (vc.pkl is the pretrained "
                         "DiT/CFM to fine-tune; whisper/campplus/rmvpe .pkl are picked "
                         "up when present; openvoice.pkl and se_db.pkl turn on the "
                         "OpenVoice timbre perturbation)")
    ap.add_argument("--val-dataset-dir", default=None,
                    help="held-out audio directory for validation")
    ap.add_argument("--validation-interval", type=int, default=0,
                    help="steps between validations (0 = off)")
    ap.add_argument("--patience", type=int, default=10,
                    help="validations without improvement before early stop")
    ap.add_argument("--weight-ema-decay", type=float, default=0.0,
                    help="keep a parameter EMA and export it for serving (0 = off)")
    ap.add_argument("--export-dir", default=None,
                    help="where to write the final serving vc.pkl (default "
                         "runs/<run-name>/ft_model)")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel width: only 1 is ported (ROADMAP queue 1 item 3c)")
    ap.add_argument("--fsdp", action="store_true",
                    help="not ported (ROADMAP queue 1 item 3c)")
    ap.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="bfloat16 = bf16 model compute, f32 master weights")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.step import MULTI_GPU
    from seedvc_tpu_torch.train.trainer import Trainer, TrainerConfig

    if args.n_model != 1 or args.fsdp:
        raise NotImplementedError(f"--n-model {args.n_model} / --fsdp: {MULTI_GPU}")
    cfg = get_preset(args.preset)
    tcfg = TrainerConfig(
        data_path=args.dataset_dir, run_dir=f"./runs/{args.run_name}",
        batch_size=args.batch_size, epochs=args.epochs, max_steps=args.max_steps,
        base_lr=args.base_lr, save_interval=args.save_interval,
        log_interval=args.log_interval, validation_interval=args.validation_interval,
        early_stop_patience=args.patience, weight_ema_decay=args.weight_ema_decay,
        fsdp=args.fsdp, compute_dtype=args.compute_dtype)
    params = {}
    if args.checkpoint_dir:
        for name, kw in (("vc", "vc_params"), ("whisper", "whisper_params"),
                         ("campplus", "campplus_params"), ("openvoice", "openvoice_params"),
                         ("rmvpe", "rmvpe_params"), ("se_db", "se_db")):
            path = os.path.join(args.checkpoint_dir, f"{name}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    params[kw] = pickle.load(f)
    trainer = Trainer(cfg, tcfg, n_model=args.n_model, device=args.device, **params)
    if trainer.restore_latest():
        print(f"resumed from step {trainer.state.step}", flush=True)
    dataset = FTDataset(args.dataset_dir, cfg.preprocess_params.sr, args.batch_size)
    val_dataset = None
    if args.val_dataset_dir:
        val_dataset = FTDataset(args.val_dataset_dir, cfg.preprocess_params.sr,
                                args.batch_size)
        if not args.validation_interval:
            print("[warn] --val-dataset-dir given but --validation-interval is 0; "
                  "validation will not run")
    final = trainer.train(dataset, val_dataset)
    serving = trainer.export_serving(args.export_dir)
    print(f"done at step {final}; serving weights: {serving} (use its directory as "
          "--checkpoint-dir for apps.infer)", flush=True)
    return trainer


if __name__ == "__main__":
    main()
