"""Resampling: host-side polyphase (scipy) for pipeline pre-processing, a
device resampler with ``torchaudio.functional.resample`` semantics (port of
``seedvc_tpu/dsp/resample.py``) for the streaming block path, and the
trainer's linear-interpolation time warp :func:`warp_rate`."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import resample_poly


def resample_host(wave, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy), as the JAX pipeline does it:
    decimating the source before it reaches the device."""
    if orig_sr == new_sr:
        return np.asarray(wave, np.float32)
    g = math.gcd(orig_sr, new_sr)
    out = resample_poly(np.asarray(wave, np.float32), new_sr // g,
                        orig_sr // g, axis=-1)
    return out.astype(np.float32)


@functools.lru_cache(maxsize=16)
def resample_filters(orig: int, new: int, lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """Hann-windowed sinc filters, one per output phase, for the reduced
    ratio ``orig -> new``: (new, 2 * width + orig) f32, and width."""
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = (-np.arange(new, dtype=np.float64) / new)[:, None] + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    denom = np.where(t == 0, 1.0, np.pi * t)
    kernels = np.where(t == 0, 1.0, np.sin(np.pi * t) / denom) * window * (base_freq / orig)
    return kernels.astype(np.float32), width


def resample_kernel(orig_sr: int, new_sr: int, device) -> torch.Tensor:
    """The filters of ``orig_sr -> new_sr`` as a conv1d weight (new, 1, K) on
    ``device``. Made once by the caller where the resampler runs inside a
    CUDA graph: a host-to-device copy cannot be captured."""
    g = math.gcd(orig_sr, new_sr)
    kernels, _ = resample_filters(orig_sr // g, new_sr // g)
    return torch.from_numpy(kernels[:, None, :]).to(device)


def resample(wave: torch.Tensor, orig_sr: int, new_sr: int,
             kernel: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T) or (T,) -> resampled along the last axis to
    ``ceil(new * T / orig)`` samples (zero edges), as one strided conv1d with
    a filter per output phase. ``kernel``: :func:`resample_kernel` of the
    same rates on wave's device, or None to make it here."""
    if orig_sr == new_sr:
        return wave
    squeeze = wave.dim() == 1
    if squeeze:
        wave = wave[None]
    g = math.gcd(orig_sr, new_sr)
    orig, new = orig_sr // g, new_sr // g
    width = resample_filters(orig, new)[1]
    if kernel is None:
        kernel = resample_kernel(orig_sr, new_sr, wave.device)
    T = wave.shape[-1]
    x = F.pad(wave, (width, width + orig))
    y = F.conv1d(x[:, None, :], kernel, stride=orig)  # (B, new, T // orig + 1)
    y = y.transpose(1, 2).reshape(wave.shape[0], -1)[:, : -(-new * T // orig)]
    return y[0] if squeeze else y


def warp_rate(wave: torch.Tensor, rate) -> torch.Tensor:
    """Fixed-shape time warp for augmentation: ``out[i] = wave[i * rate]`` by
    linear interpolation along the last axis, zero past the warped end (a
    copy of ``seedvc_tpu/dsp/resample.py::warp_rate``). ``rate`` is a float
    or a 0-d tensor; the trainer passes 1/(drawn rate). No anti-alias filter:
    an augmentation, not a resampler for inference."""
    T = wave.shape[-1]
    rate = torch.as_tensor(rate, dtype=torch.float32, device=wave.device)
    pos = torch.arange(T, dtype=torch.float32, device=wave.device) * rate
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, T - 1)
    frac = pos - i0.to(torch.float32)
    g0 = wave[..., i0]
    g1 = wave[..., torch.clamp(i0 + 1, 0, T - 1)]
    out = g0 * (1.0 - frac) + g1 * frac
    return torch.where(pos <= T - 1, out, torch.zeros_like(out))
