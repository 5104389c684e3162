"""Objective evaluation harness (port of ``seedvc_tpu/apps/eval.py``): converts
every source utterance of a directory against every reference voice of
another and scores the conversions.

    python -m seedvc_tpu_torch.apps.eval --source-dir src/ --target-dir refs/ \
        --output out/ --checkpoint-dir ckpts/ --max-samples 20

Runs on ``cuda`` unless ``--device cpu`` is given (and raises without a card).

Metrics:
- SECS, speaker-embedding cosine similarity. ``--xvector-extractor wavlm``
  scores with the WavLM x-vector (``models/wavlm_sv.py``; the reference's
  microsoft/wavlm-base-plus-sv, converted with ``python -m
  seedvc_tpu_torch.apps.convert_checkpoint --wavlm-sv`` and passed as
  ``--xvector-checkpoint``), each clip zero-padded to a 5 s
  bucket with its true length; CAMPPlus, the encoder the model conditions on,
  is then a second column ``secs_campplus`` (as the first it would grade the
  model by its own encoder).
- WER/CER with a local HF CTC checkpoint (``--asr-model``) against the
  ``--transcripts`` TSV (filename<TAB>text) or, without one, the source's own
  transcript.
- DNSMOS SIG/BAK/OVRL (and P.808) with the ONNX models of ``--dnsmos-dir``
  (needs ``onnxruntime``).
- ``--f0-metrics``: F0CORR / F0RMSE of source against conversion by RMVPE
  (F0-conditioned presets).
- ``--baseline openvoice --baseline-checkpoint ov.pkl``, ``--baseline
  cosyvoice`` or ``--baseline command --baseline-cmd '... {source}
  {reference} {output}'`` score a baseline system instead of the model.

Converted wavs are kept in ``--output`` and a second run reuses them (resume);
``results.json`` holds the per-pair rows and their means.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def secs(emb_a, emb_b) -> float:
    """Cosine similarity of two embeddings (arrays or tensors)."""
    import numpy as np
    import torch

    def flat(e):
        if isinstance(e, torch.Tensor):
            e = e.detach().float().cpu().numpy()
        return np.asarray(e).ravel()

    a, b = flat(emb_a), flat(emb_b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def main(argv=None):
    """Evaluate; returns the ``results.json`` contents."""
    ap = argparse.ArgumentParser(description="seedvc_tpu_torch evaluation")
    ap.add_argument("--source-dir", required=True)
    ap.add_argument("--target-dir", required=True, help="reference voices")
    ap.add_argument("--output", default="./eval_out")
    ap.add_argument("--preset", default="whisper_small_wavenet")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--diffusion-steps", type=int, default=25)
    ap.add_argument("--inference-cfg-rate", type=float, default=0.7)
    ap.add_argument("--max-samples", type=int, default=20)
    ap.add_argument("--xvector-extractor", default="campplus", choices=["campplus", "wavlm"],
                    help="speaker embedding for SECS (the reference defaults to "
                         "wavlm-base-plus-sv)")
    ap.add_argument("--xvector-checkpoint", default=None,
                    help="wavlm extractor: pkl of converted WavLMSV params "
                         "(random weights without it: scores meaningless)")
    ap.add_argument("--asr-model", default=None,
                    help="local HF CTC ASR model dir for WER/CER (optional)")
    ap.add_argument("--transcripts", default=None,
                    help="TSV of filename<TAB>ground-truth text")
    ap.add_argument("--dnsmos-dir", default=None,
                    help="dir with sig_bak_ovr.onnx (needs onnxruntime)")
    ap.add_argument("--f0-metrics", action="store_true",
                    help="F0CORR/F0RMSE source vs converted via RMVPE (F0-conditioned "
                         "presets)")
    ap.add_argument("--baseline", default=None, choices=["openvoice", "cosyvoice", "command"],
                    help="score a baseline system instead of the model")
    ap.add_argument("--baseline-checkpoint", default=None,
                    help="openvoice baseline: converted openvoice.pkl")
    ap.add_argument("--baseline-cmd", default=None,
                    help="command baseline template with {source} {reference} {output}")
    ap.add_argument("--cosyvoice-dir", default=None,
                    help="cosyvoice baseline: path of a CosyVoice checkout (required)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from seedvc_tpu_torch.apps import metrics
    from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav, scan_audio_files
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.dsp.resample import resample
    from seedvc_tpu_torch.pipelines import convert
    from seedvc_tpu_torch.pipelines.wrapper import load_params_dir

    converter = convert.VoiceConverter(get_preset(args.preset), device=args.device,
                                       **load_params_dir(args.checkpoint_dir))
    device = converter.device

    def to_16k(wave, sr) -> np.ndarray:
        return resample(torch.from_numpy(wave).to(device), sr, 16000).cpu().numpy()

    if args.xvector_extractor == "wavlm":
        from seedvc_tpu_torch.models import wavlm_sv
        from seedvc_tpu_torch.weights import load_jax_params

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            wavlm = wavlm_sv.WavLMSV(wavlm_sv.WAVLM_BASE_PLUS_SV)
        if args.xvector_checkpoint:
            with open(args.xvector_checkpoint, "rb") as f:
                load_jax_params(wavlm, pickle.load(f))
        else:
            print("WARNING: --xvector-extractor wavlm without --xvector-checkpoint: random "
                  "weights, SECS meaningless")
        wavlm.requires_grad_(False).eval().to(device)

        @torch.no_grad()
        def embed(wave_16k):
            # 5 s buckets; the true length masks the padding out of the
            # normalisation, GroupNorm, attention and pooling
            bucket = 5 * 16000
            padded = np.zeros(-(-max(len(wave_16k), 8000) // bucket) * bucket, np.float32)
            padded[: len(wave_16k)] = wave_16k
            return wavlm(torch.from_numpy(padded[None]).to(device),
                         lengths=torch.tensor([len(wave_16k)], device=device))
    else:
        def embed(wave_16k):
            return converter.compute_style(wave_16k)

    baseline = None
    if args.baseline:
        from seedvc_tpu_torch.apps.baselines import get_baseline

        baseline = get_baseline(args.baseline, checkpoint_pkl=args.baseline_checkpoint,
                                template=args.baseline_cmd, repo_dir=args.cosyvoice_dir,
                                device=device)

    transcripts = {}
    if args.transcripts:
        with open(args.transcripts) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    transcripts[os.path.splitext(parts[0])[0]] = parts[1]
    transcriber = metrics.CTCTranscriber(args.asr_model, device=device) if args.asr_model \
        else None
    dnsmos = metrics.DNSMOS(args.dnsmos_dir) if args.dnsmos_dir else None

    sources = scan_audio_files(args.source_dir)[: args.max_samples]
    targets = scan_audio_files(args.target_dir)
    os.makedirs(args.output, exist_ok=True)
    results = []
    for ti, tgt_path in enumerate(targets):
        ref, ref_sr = load_wav(tgt_path)
        ref_16k = to_16k(ref, ref_sr)
        ref_emb = embed(ref_16k)
        ref_emb_cp = (ref_emb if args.xvector_extractor == "campplus"
                      else converter.compute_style(ref_16k))
        for si, src_path in enumerate(sources):
            src, src_sr = load_wav(src_path)
            out_name = (f"{os.path.basename(tgt_path).split('.')[0]}_"
                        f"{os.path.basename(src_path).split('.')[0]}.wav")
            out_path = os.path.join(args.output, out_name)
            if os.path.exists(out_path):  # cache and resume
                wave, sr = load_wav(out_path)
            elif baseline is not None:
                baseline.convert(src_path, tgt_path, out_path)
                wave, sr = load_wav(out_path)
            else:
                sr, wave, _ = converter.convert(src, src_sr, ref, ref_sr,
                                                diffusion_steps=args.diffusion_steps,
                                                cfg_rate=args.inference_cfg_rate)
                save_wav(out_path, wave, sr)
            conv_16k = to_16k(wave, sr)
            row = {"source": src_path, "target": tgt_path,
                   "secs": secs(embed(conv_16k), ref_emb)}
            if args.xvector_extractor != "campplus":
                row["secs_campplus"] = secs(converter.compute_style(conv_16k), ref_emb_cp)

            src_16k = None
            if transcriber is not None:
                hyp = transcriber.transcribe(conv_16k)
                ref_text = transcripts.get(os.path.splitext(os.path.basename(src_path))[0])
                if ref_text is None:
                    src_16k = to_16k(src, src_sr)
                    ref_text = transcriber.transcribe(src_16k)
                row["wer"] = metrics.wer(ref_text, hyp)
                row["cer"] = metrics.cer(ref_text, hyp)
            if dnsmos is not None:
                row.update({f"dnsmos_{k}": v for k, v in dnsmos.score(conv_16k).items()})
            if args.f0_metrics and converter.rmvpe is not None:
                src_16k = to_16k(src, src_sr) if src_16k is None else src_16k
                f0_src = converter.rmvpe.infer_from_audio_batch(src_16k[None])[0]
                f0_conv = converter.rmvpe.infer_from_audio_batch(conv_16k[None])[0]
                row.update(metrics.f0_metrics(f0_src, f0_conv))
            results.append(row)
            print(f"[{ti}:{si}] SECS={row['secs']:.4f} {out_name}", flush=True)

    summary = {"n": len(results)}
    for metric in ("secs", "secs_campplus", "wer", "cer", "dnsmos_sig", "dnsmos_bak",
                   "dnsmos_ovrl", "dnsmos_p808", "f0_corr", "f0_rmse_cents"):
        vals = [r[metric] for r in results if metric in r and np.isfinite(r[metric])]
        if vals:
            summary[f"mean_{metric}"] = float(np.mean(vals))
    report = {"summary": summary, "results": results}
    with open(os.path.join(args.output, "results.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(summary), flush=True)
    return report


if __name__ == "__main__":
    main()
