"""Log-mel spectrogram frontend (port of ``seedvc_tpu/dsp/mel.py``).

1. reflect-pad the waveform by (n_fft - hop)//2 on both sides,
2. STFT with a periodic Hann window, center=False,
3. magnitude = sqrt(re^2 + im^2 + 1e-9),
4. matmul with a Slaney-normalised mel filterbank (librosa's algorithm),
5. log(clamp(x, min=1e-5)).

Output layout is (B, n_frames, n_mels), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vcbench.ref.core.config import SpectConfig
from vcbench.ref.dsp.stft import stft_magnitude


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window (periodic by default, as torch.hann_window)."""
    n = win_length if periodic else win_length - 1
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / n))).astype(np.float32)


def _hz_to_mel(hz, htk: bool = False):
    hz = np.asarray(hz, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz,
                    min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep,
                    hz / f_sp)


def _mel_to_hz(mel, htk: bool = False):
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), mel * f_sp)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank, (n_mels, n_fft//2 + 1), librosa defaults."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights = weights * (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(y: torch.Tensor, sr: int, n_fft: int, hop_length: int,
                        win_length: int, n_mels: int, fmin: float = 0.0,
                        fmax: float | None = None) -> torch.Tensor:
    """(B, T) waveform in [-1, 1] -> (B, T//hop, n_mels) log-mel, f32."""
    pad = (n_fft - hop_length) // 2
    y = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    window = hann_window(win_length)
    if win_length < n_fft:  # torch pads the window symmetrically to n_fft
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    mag = stft_magnitude(y, n_fft, hop_length, torch.from_numpy(window).to(y.device))
    basis = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T).to(y.device)
    return torch.log(torch.clamp(mag @ basis, min=1e-5))


class MelFrontend:
    """Config-bound mel function."""

    def __init__(self, sr: int, spect: SpectConfig):
        self.sr = sr
        self.spect = spect

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        s = self.spect
        return log_mel_spectrogram(y, self.sr, s.n_fft, s.hop_length, s.win_length,
                                   s.n_mels, s.fmin, s.fmax)
