"""Kaldi-compatible log-mel filterbank features (input to CAMPPlus).

Semantics of ``torchaudio.compliance.kaldi.fbank`` with ``num_mel_bins=80,
dither=0, sample_frequency=16000`` and Kaldi defaults elsewhere:

- 25 ms / 10 ms frames (400/160 samples at 16 kHz), snip_edges=True,
- per-frame DC offset removal, pre-emphasis 0.97 (first sample replicated),
- povey window ``(0.5 - 0.5 cos(2 pi n/(N-1)))**0.85``,
- zero-pad to 512, power spectrum,
- HTK-mel triangular bank computed in mel space, low 20 Hz, high = Nyquist,
- ``log(max(mel, eps_f32))``.

The caller subtracts the per-utterance mean.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def povey_window(n: int) -> np.ndarray:
    i = np.arange(n)
    return ((0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85).astype(np.float32)


def _mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int, padded_window_size: int, sr: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, padded_window_size//2 + 1) triangular bank, mel-space slopes;
    the Nyquist column is zero. high_freq <= 0 means Nyquist + high_freq."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    n_fft_bins = padded_window_size // 2
    fft_bin_width = sr / padded_window_size
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, n_fft_bins + 1), np.float64)
    mel_freqs = _mel(np.arange(n_fft_bins) * fft_bin_width)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[b, :n_fft_bins] = np.clip(np.minimum(up, down), 0.0, None)
    return bins.astype(np.float32)


def kaldi_fbank(wave: torch.Tensor, num_mel_bins: int = 80, sr: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97) -> torch.Tensor:
    """(B, T) waveform in [-1, 1] -> (B, n_frames, num_mel_bins) log-mel, f32."""
    win = int(sr * frame_length_ms / 1000)
    hop = int(sr * frame_shift_ms / 1000)
    padded = _next_pow2(win)
    frames = wave.float().unfold(-1, win, hop)  # (B, N, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(povey_window(win)).to(frames.device)
    frames = F.pad(frames, (0, padded - win))
    spec = torch.view_as_real(torch.fft.rfft(frames, dim=-1))
    power = spec[..., 0] ** 2 + spec[..., 1] ** 2
    banks = torch.from_numpy(kaldi_mel_banks(num_mel_bins, padded, float(sr)).T).to(frames.device)
    return torch.log(torch.clamp(power @ banks, min=float(np.finfo(np.float32).eps)))
