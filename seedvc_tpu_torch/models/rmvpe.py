"""RMVPE F0 extractor (deep U-Net + BiGRU salience model), port of
``seedvc_tpu/models/rmvpe.py``; channels-first (B, C, T, F) inside.

- mel: 128-band HTK-scale mel (slaney-normalised) of 16 kHz audio, window
  1024, hop 160, 30-8000 Hz, reflect-padded by 512 (center=True),
  ``log(max(mel, 1e-5))``;
- E2E: BatchNorm -> encoder stages (residual conv blocks + 2x2 average pool)
  -> intermediate blocks -> decoder stages (transposed conv + skip concat)
  -> 3-channel conv -> BiGRU(384 -> 2 x 256) -> linear -> sigmoid over 360
  cents bins;
- decoding: the salience-weighted mean of cents over +-4 bins around the
  argmax, thresholded, ``f0 = 10 * 2^(cents / 1200)``, on the host in numpy.

The JAX package writes the DFT as matmuls, the GRU as a ``lax.scan`` and the
convolutions for XLA; none of them is a TPU kernel, so here they are
``torch.stft``, ``nn.GRU`` and cuDNN convolutions. BatchNorms run frozen.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from seedvc_tpu_torch.core.profiling import StageTimer
from seedvc_tpu_torch.dsp.mel import hann_window, mel_filterbank
from seedvc_tpu_torch.dsp.stft import stft_magnitude

N_MELS = 128
N_CLASS = 360
N_FFT, HOP = 1024, 160


def rmvpe_mel(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, 1 + T // 160, 128) log-mel, center=True."""
    y = F.pad(audio.float()[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    window = torch.from_numpy(hann_window(N_FFT)).to(y.device)
    mag = stft_magnitude(y, N_FFT, HOP, window, eps=0.0)
    basis = torch.from_numpy(
        mel_filterbank(16000, N_FFT, N_MELS, 30.0, 8000.0, htk=True).T).to(y.device)
    return torch.log(torch.clamp(mag @ basis, min=1e-5))


class ConvBlockRes(nn.Module):
    """(3x3 conv, no bias -> BN -> ReLU) twice, plus the input, through a 1x1
    conv when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(out_channels)
        self.conv1 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn0(self.conv0(x)))
        h = F.relu(self.bn1(self.conv1(h)))
        return h + (self.shortcut(x) if hasattr(self, "shortcut") else x)


class RMVPE_E2E(nn.Module):
    """Salience model. The defaults are the released checkpoint's geometry;
    tests build reduced ones."""

    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5, inter_layers: int = 4,
                 en_out_channels: int = 16):
        super().__init__()
        self.n_blocks, self.en_de_layers, self.inter_layers = n_blocks, en_de_layers, inter_layers
        self.encoder_bn = nn.BatchNorm2d(1)
        in_ch, out_ch = 1, en_out_channels
        for i in range(en_de_layers):
            for b in range(n_blocks):
                self.add_module(f"enc_{i}_block_{b}",
                                ConvBlockRes(in_ch if b == 0 else out_ch, out_ch))
            in_ch, out_ch = out_ch, out_ch * 2
        for j in range(inter_layers):
            for b in range(n_blocks):
                self.add_module(f"inter_{j}_block_{b}",
                                ConvBlockRes(in_ch if j == 0 and b == 0 else out_ch, out_ch))
        ch = out_ch
        for i in range(en_de_layers):
            self.add_module(f"dec_{i}_up", nn.ConvTranspose2d(
                ch, ch // 2, 3, stride=2, padding=1, output_padding=1, bias=False))
            ch //= 2
            self.add_module(f"dec_{i}_bn", nn.BatchNorm2d(ch))
            for b in range(n_blocks):
                self.add_module(f"dec_{i}_block_{b}", ConvBlockRes(2 * ch if b == 0 else ch, ch))
        self.cnn = nn.Conv2d(ch, 3, 3, padding=1)
        self.gru_fwd = nn.GRU(3 * N_MELS, 256, batch_first=True)
        self.gru_bwd = nn.GRU(3 * N_MELS, 256, batch_first=True)
        self.fc_linear = nn.Linear(512, N_CLASS)

    def features(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, 128), T a multiple of 2^en_de_layers -> the U-Net's
        3-channel map flattened channel-major, (B, T, 384): index c * 128 + f."""
        x = self.encoder_bn(mel[:, None])
        skips = []
        for i in range(self.en_de_layers):
            for b in range(self.n_blocks):
                x = getattr(self, f"enc_{i}_block_{b}")(x)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        for j in range(self.inter_layers):
            for b in range(self.n_blocks):
                x = getattr(self, f"inter_{j}_block_{b}")(x)
        for i in range(self.en_de_layers):
            x = F.relu(getattr(self, f"dec_{i}_bn")(getattr(self, f"dec_{i}_up")(x)))
            x = torch.cat([x, skips[-1 - i]], dim=1)
            for b in range(self.n_blocks):
                x = getattr(self, f"dec_{i}_block_{b}")(x)
        return self.cnn(x).transpose(1, 2).flatten(-2)

    def gru(self, h: torch.Tensor) -> torch.Tensor:
        """The BiGRU: (B, T, 384) -> (B, T, 512), the forward scan's states
        then the backward scan's (run over the time-reversed sequence)."""
        fwd = self.gru_fwd(h)[0]
        bwd = self.gru_bwd(h.flip(1))[0].flip(1)
        return torch.cat([fwd, bwd], dim=-1)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """(B, T, 512) -> the salience (B, T, 360): the linear layer, sigmoid."""
        return torch.sigmoid(self.fc_linear(h))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, 128), T a multiple of 2^en_de_layers -> salience
        (B, T, 360)."""
        return self.head(self.gru(self.features(mel)))


CENTS_MAPPING = 20 * np.arange(360) + 1997.3794084376191


def decode_f0(salience: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """(T, 360) salience -> (T,) F0 Hz (reference ``to_local_average_cents``)."""
    center = np.argmax(salience, axis=1) + 4
    sal = np.pad(salience, ((0, 0), (4, 4)))
    cents = np.pad(CENTS_MAPPING, (4, 4))
    idx = center[:, None] + np.arange(-4, 5)[None, :]
    todo_sal = np.take_along_axis(sal, idx, axis=1)
    todo_cents = cents[idx]
    with np.errstate(invalid="ignore", divide="ignore"):
        devided = (todo_sal * todo_cents).sum(1) / todo_sal.sum(1)
    maxx = sal.max(axis=1)
    devided[maxx <= thred] = 0  # also overwrites NaNs from all-zero rows
    f0 = 10 * 2 ** (devided / 1200)
    f0[f0 == 10] = 0
    return f0


class RMVPE:
    """Bundled mel + E2E + decode (reference RMVPE class) around a frozen
    :class:`RMVPE_E2E` on its device.

    Given a :class:`~seedvc_tpu_torch.core.profiling.StageTimer`, a call's
    device work is its stage ``f0.salience`` (counting ``frames``, the real
    frames, and ``padded_frames``), which holds ``f0.gru`` (counting
    ``gru_steps``, both scans' steps); the host's decode is ``f0.decode``.
    None of them synchronises: their device times are read once the copy of
    the salience to the host has waited for it."""

    def __init__(self, model: RMVPE_E2E):
        self.model = model
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def salience(self, audio_16k, timer: Optional[StageTimer] = None) -> torch.Tensor:
        """(B, T) 16 kHz audio (numpy or tensor) -> (B, n_frames, 360). The
        log-mel is zero-padded to a multiple of 32 frames after the log, and
        both GRU directions run over the padded length before the crop."""
        timer = timer or StageTimer(enabled=False)
        with timer("f0.salience"):
            mel = rmvpe_mel(torch.as_tensor(np.asarray(audio_16k, np.float32)).to(self.device))
            n_frames = mel.shape[1]
            padded = -(-n_frames // 32) * 32
            mel = F.pad(mel, (0, 0, 0, padded - n_frames))
            timer.count("frames", mel.shape[0] * n_frames)
            timer.count("padded_frames", mel.shape[0] * padded)
            h = self.model.features(mel)
            with timer("f0.gru"):
                h = self.model.gru(h)
                timer.count("gru_steps", 2 * padded)
            return self.model.head(h)[:, :n_frames]

    def infer_from_audio_batch(self, audio_16k, thred: float = 0.03,
                               timer: Optional[StageTimer] = None,
                               keep: Optional[list] = None) -> np.ndarray:
        """(B, T) 16 kHz audio -> (B, n_frames) F0 Hz; ``keep``: a list the
        salience's host copy (B, n_frames, 360) f32 is appended to."""
        timer = timer or StageTimer(enabled=False)
        hidden = self.salience(audio_16k, timer).float().cpu().numpy()
        if keep is not None:
            keep.append(hidden)
        with timer("f0.decode"):
            return np.stack([decode_f0(h, thred) for h in hidden])
