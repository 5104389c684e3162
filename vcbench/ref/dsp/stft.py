"""STFT magnitude (center=False) on ``torch.stft``, and the inverse STFT.

The JAX package writes the DFT as two matmuls against cos/sin bases, a
rewrite for the TPU's matrix unit; on the GPU ``torch.stft`` and
``torch.fft.irfft`` compute the same transforms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
                   eps: float = 1e-9) -> torch.Tensor:
    """|STFT| of (B, T) -> (B, n_frames, n_fft//2 + 1), center=False, as
    ``sqrt(re^2 + im^2 + eps)``. The window must already be n_fft long."""
    spec = torch.stft(y, n_fft, hop_length=hop, win_length=n_fft, window=window,
                      center=False, return_complex=True)
    spec = torch.view_as_real(spec)
    mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2 + eps)
    return mag.transpose(1, 2)


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int, hop: int,
          window: torch.Tensor) -> torch.Tensor:
    """Inverse STFT with center=True semantics, port of
    ``seedvc_tpu/dsp/stft.py::istft``: (B, n_frames, n_fft//2 + 1) real and
    imaginary parts -> (B, hop * (n_frames - 1)). Each frame's inverse real
    DFT (the imaginary parts of the DC and Nyquist bins are ignored) is
    windowed, overlap-added, divided by the overlap-added squared window
    floored at 1e-11, and the n_fft//2 centre padding is trimmed.

    ``torch.istft`` is not used: its envelope check reads the device, which
    a CUDA graph cannot capture."""
    frames = torch.fft.irfft(torch.complex(spec_real, spec_imag), n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    total = n_fft + hop * (n_frames - 1)

    def overlap_add(x):  # (B, n_frames, n_fft) -> (B, total)
        return F.fold(x.transpose(1, 2), (1, total), (1, n_fft), stride=(1, hop))[:, 0, 0]

    wsq = overlap_add((window * window).expand(1, n_frames, n_fft))
    sig = overlap_add(frames) / torch.clamp(wsq, min=1e-11)
    return sig[:, n_fft // 2: total - n_fft // 2]
