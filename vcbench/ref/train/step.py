"""Plain fine-tuning steps for the benchmark's check: a frozen copy of the
port's v1 batch preparation (``train/trainer.py::prepare_batch`` without
the feature cache, OpenVoice or F0) and of its one-process train step
(``train/step.py::make_train_step``): loss, backward, clip + AdamW."""

from __future__ import annotations

import numpy as np
import torch

from vcbench.ref.dsp.fbank import kaldi_fbank
from vcbench.ref.dsp.resample import warp_rate
from vcbench.ref.dsp.whisper_mel import whisper_log_mel
from vcbench.ref.train.optim import apply_updates, global_norm


def padded_mel(mel_fn, waves, mel_lens):
    mels = mel_fn(waves)
    pos = torch.arange(mels.shape[1], device=mels.device)[None, :]
    return torch.where((pos < mel_lens[:, None])[..., None], mels, torch.full_like(mels, -10.0))


def batch_style(campplus, w16, frame_lens):
    fb = kaldi_fbank(w16)
    fmask = (torch.arange(fb.shape[1], device=fb.device)[None, :]
             < frame_lens[:, None]).to(fb.dtype)[..., None]
    mean = (fb * fmask).sum(dim=1, keepdim=True) / torch.clamp(
        frame_lens[:, None, None].to(fb.dtype), min=1.0)
    return campplus((fb - mean) * fmask, frame_lens)


def prepare_batch(batch, rng, *, mel_fn, whisper, campplus, hop, mel_bucket, perturb,
                  device, enc_dtype=torch.float32):
    """The step's inputs from one dataset batch, every feature computed."""
    mel_lens = (batch.wave_lengths // hop).astype(np.int32)
    bucket = -(-int(mel_lens.max()) // mel_bucket) * mel_bucket
    B = batch.waves.shape[0]
    waves = np.zeros((B, bucket * hop), np.float32)
    n = min(waves.shape[1], batch.waves.shape[1])
    waves[:, :n] = batch.waves[:, :n]
    mel_lens_d = torch.from_numpy(mel_lens).to(device)
    mels = padded_mel(mel_fn, torch.from_numpy(waves).to(device), mel_lens_d)
    w16_T = min(-(-batch.waves_16k.shape[1] // 16000) * 16000, 30 * 16000)
    w16b = np.zeros((B, w16_T), np.float32)
    nb = min(w16_T, batch.waves_16k.shape[1])
    w16b[:, :nb] = batch.waves_16k[:, :nb]
    eff_16k = np.minimum(batch.wave_16k_lengths, w16_T)
    frame_lens = np.maximum((eff_16k - 400) // 160 + 1, 1).astype(np.int32)
    w16 = torch.from_numpy(w16b).to(device)
    alt = warp_rate(w16, np.float32(1.0 / rng.uniform(*perturb)))

    def content(x):
        return whisper(whisper_log_mel(x).to(enc_dtype)).float()

    s_ori, s_alt = content(w16), content(alt)
    style = batch_style(campplus, w16, torch.from_numpy(frame_lens).to(device))
    s_true = int(eff_16k.max()) // 320 + 1
    s_bucket = min(-(-s_true // 64) * 64, s_ori.shape[1], s_alt.shape[1])
    return {"s_alt": s_alt[:, :s_bucket], "s_ori": s_ori[:, :s_bucket],
            "s_lens": torch.tensor(min(s_true, s_bucket), dtype=torch.int32, device=device),
            "mels": mels, "mel_lens": mel_lens_d, "style": style}


def train_step(model, optimizer, opt_state, feats, draws):
    """One step: (loss, clipped-to-be gradients by name, new opt state); the
    parameters are updated in place."""
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, _ = model(feats["s_alt"], feats["s_ori"], feats["mels"], feats["mel_lens"],
                        feats["style"], draws, s_lens=feats["s_lens"])
        loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    gnorm = global_norm(grads.values())
    updates, opt_state = optimizer.update(grads, opt_state, params)
    apply_updates(params, updates)
    return loss.detach(), grads, gnorm, opt_state
