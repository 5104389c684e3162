"""STFT magnitude (center=False), on ``torch.stft``.

The JAX package writes the DFT as two matmuls against cos/sin bases, a
rewrite for the TPU's matrix unit; on the GPU ``torch.stft`` computes the
same transform.
"""

from __future__ import annotations

import torch


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
                   eps: float = 1e-9) -> torch.Tensor:
    """|STFT| of (B, T) -> (B, n_frames, n_fft//2 + 1), center=False, as
    ``sqrt(re^2 + im^2 + eps)``. The window must already be n_fft long."""
    spec = torch.stft(y, n_fft, hop_length=hop, win_length=n_fft, window=window,
                      center=False, return_complex=True)
    spec = torch.view_as_real(spec)
    mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2 + eps)
    return mag.transpose(1, 2)
