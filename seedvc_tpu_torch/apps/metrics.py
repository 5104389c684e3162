"""Objective evaluation metrics (port of ``seedvc_tpu/apps/metrics.py``).

- WER/CER: the edit distances in plain Python (no jiwer), the ASR a gated
  adapter over a *local* HF CTC checkpoint (``transformers`` imported when
  one is built), on an explicit device;
- DNSMOS: a gated adapter over the published ONNX models (``onnxruntime``
  imported when one is built), with the P.808 model's mel features in numpy;
- F0CORR / F0RMSE over jointly voiced frames.

SECS lives in ``seedvc_tpu_torch.apps.eval``.
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over tokens (words or characters)."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1,          # deletion
                         cur[j - 1] + 1,       # insertion
                         prev[j - 1] + (r != h))  # substitution
        prev = cur
    return prev[-1]


def normalize_text(text: str) -> str:
    """Uppercase, strip punctuation, collapse whitespace (jiwer-style)."""
    text = re.sub(r"[^\w\s']", " ", text.upper())
    return " ".join(text.split())


def wer(ref_text: str, hyp_text: str) -> float:
    """Word error rate between a reference transcript and a hypothesis."""
    ref = normalize_text(ref_text).split()
    hyp = normalize_text(hyp_text).split()
    return edit_distance(ref, hyp) / max(len(ref), 1)


def cer(ref_text: str, hyp_text: str) -> float:
    """Character error rate over the normalised strings, spaces kept."""
    ref = normalize_text(ref_text)
    hyp = normalize_text(hyp_text)
    return edit_distance(ref, hyp) / max(len(ref), 1)


class CTCTranscriber:
    """ASR adapter over a local HF CTC checkpoint (hubert / wav2vec2 family),
    the reference's hubert-large-ls960-ft. Runs on ``device`` (``cuda``
    unless told otherwise; raises without a card)."""

    def __init__(self, model_dir: str, device="cuda"):
        import torch
        from transformers import AutoModelForCTC, AutoProcessor

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CTCTranscriber: no CUDA device; pass device='cpu'")
        self.torch = torch
        self.processor = AutoProcessor.from_pretrained(model_dir)
        self.model = AutoModelForCTC.from_pretrained(model_dir).eval().to(self.device)

    def transcribe(self, wave_16k) -> str:
        inputs = self.processor(wave_16k, sampling_rate=16000, return_tensors="pt")
        with self.torch.no_grad():
            logits = self.model(inputs.input_values.to(self.device)).logits
        return self.processor.decode(logits.argmax(-1)[0].cpu())


def p808_melspec(audio_16k) -> np.ndarray:
    """Mel features of the DNSMOS P.808 model: torchaudio
    MelSpectrogram(sr=16000, n_fft=321, hop=160, n_mels=120, slaney mel
    scale, norm None, power 2, centred with reflect padding), then
    ``(librosa.power_to_db(ref=max) + 40) / 40``, as (T, 120)."""
    from seedvc_tpu_torch.dsp.mel import hann_window, mel_filterbank

    n_fft, hop, n_mels = 321, 160, 120
    audio = np.asarray(audio_16k, np.float32)
    pad = n_fft // 2
    padded = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // hop  # odd n_fft: 2 * pad = n_fft - 1
    win = hann_window(n_fft, periodic=True)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    spec = np.abs(np.fft.rfft(padded[idx] * win[None, :], n=n_fft, axis=-1)) ** 2
    fb = mel_filterbank(16000, n_fft, n_mels, fmin=0.0, fmax=8000.0, norm=None)
    mel = spec @ fb.T  # (T, 120)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = db - 10.0 * np.log10(np.maximum(mel.max(), 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    return ((db + 40.0) / 40.0).astype(np.float32)


class DNSMOS:
    """DNSMOS over the published ONNX models: ``model_dir`` holds
    ``sig_bak_ovr.onnx`` (P.835 SIG/BAK/OVRL) and optionally
    ``model_v8.onnx`` (the P.808 MOS column). Needs ``onnxruntime``; runs on
    the CPU, as the reference scorer does."""

    INPUT_LENGTH_S = 9.01

    def __init__(self, model_dir: str):
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise RuntimeError("DNSMOS scoring requires the optional 'onnxruntime' "
                               "package") from e
        self.sess = ort.InferenceSession(os.path.join(model_dir, "sig_bak_ovr.onnx"),
                                         providers=["CPUExecutionProvider"])
        self.p808_sess = None
        p808_path = os.path.join(model_dir, "model_v8.onnx")
        if os.path.exists(p808_path):
            self.p808_sess = ort.InferenceSession(p808_path,
                                                  providers=["CPUExecutionProvider"])

    @staticmethod
    def _poly_fit(sig, bak, ovr):
        """The published polynomial mapping from raw to MOS scores."""
        p_sig = (-0.08397278, 1.22083953, 0.0052439)
        p_bak = (-0.13166888, 1.60915514, -0.39604546)
        p_ovr = (-0.06766283, 1.11546468, 0.04602535)

        def poly(p, x):
            return p[0] * x ** 2 + p[1] * x + p[2]

        return poly(p_sig, sig), poly(p_bak, bak), poly(p_ovr, ovr)

    def score(self, wave_16k) -> dict:
        fs = 16000
        need = int(self.INPUT_LENGTH_S * fs)
        wave = np.asarray(wave_16k, np.float32)
        if len(wave) == 0:
            raise ValueError("DNSMOS.score: empty waveform")
        while len(wave) < need:
            wave = np.concatenate([wave, wave])
        sigs, baks, ovrs, p808s = [], [], [], []
        for start in range(0, len(wave) - need + 1, fs):  # 1 s hops over 9.01 s windows
            seg = wave[start: start + need]
            s, b, o = self._poly_fit(*self.sess.run(None, {"input_1": seg[None]})[0][0])
            sigs.append(s)
            baks.append(b)
            ovrs.append(o)
            if self.p808_sess is not None:
                # the reference feeds audio_seg[:-160]
                feats = p808_melspec(seg[:-160])[None]
                p808s.append(float(self.p808_sess.run(None, {"input_1": feats})[0][0][0]))
        out = {"sig": float(np.mean(sigs)), "bak": float(np.mean(baks)),
               "ovrl": float(np.mean(ovrs))}
        if p808s:
            out["p808"] = float(np.mean(p808s))
        return out


def f0_metrics(f0_ref, f0_hyp) -> dict:
    """F0CORR (Pearson on Hz) and F0RMSE (cents) over jointly voiced frames
    (F0 > 1 Hz on both sides), the two sequences cut to the shorter."""
    a = np.asarray(f0_ref, np.float64)
    b = np.asarray(f0_hyp, np.float64)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    voiced = (a > 1) & (b > 1)
    if voiced.sum() < 2:
        return {"f0_corr": float("nan"), "f0_rmse_cents": float("nan"),
                "voiced_frames": int(voiced.sum())}
    av, bv = a[voiced], b[voiced]
    corr = float(np.corrcoef(av, bv)[0, 1])
    rmse = float(np.sqrt(np.mean((1200.0 * np.log2(bv / av)) ** 2)))
    return {"f0_corr": corr, "f0_rmse_cents": rmse, "voiced_frames": int(voiced.sum())}
