"""Whisper log-mel frontend (HF WhisperFeatureExtractor semantics).

- pad/truncate audio to 30 s (480000 samples at 16 kHz),
- STFT: n_fft 400, hop 160, periodic Hann, center=True reflect padding,
- power spectrum, Slaney mel bank (80 bins, 0..8000 Hz),
- ``log10(clip(mel, 1e-10))``, floored at the global max - 8, then ``(x+4)/4``,
- drop the final frame -> exactly 3000 frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vcbench.ref.dsp.mel import hann_window, mel_filterbank

N_FFT = 400
HOP = 160
N_MELS = 80
SR = 16000
CHUNK = 30 * SR


def whisper_log_mel(wave: torch.Tensor) -> torch.Tensor:
    """(B, T<=480000) -> (B, 3000, 80) whisper-normalised log-mel, f32."""
    wave = F.pad(wave.float(), (0, CHUNK - wave.shape[1]))
    y = F.pad(wave[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    window = torch.from_numpy(hann_window(N_FFT)).to(y.device)
    spec = torch.view_as_real(torch.stft(y, N_FFT, hop_length=HOP, window=window,
                                         center=False, return_complex=True))
    power = (spec[..., 0] ** 2 + spec[..., 1] ** 2).transpose(1, 2)[:, :-1]
    basis = torch.from_numpy(mel_filterbank(SR, N_FFT, N_MELS, 0.0, 8000.0).T).to(y.device)
    log_spec = torch.log10(torch.clamp(power @ basis, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0
