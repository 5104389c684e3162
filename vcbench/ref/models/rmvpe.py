"""RMVPE F0 extractor, plain: the log-mel, the deep U-Net, the bidirectional
GRU as its recurrence equations in a loop over frames, the linear layer and
sigmoid, and the reference's ``to_local_average_cents`` decoding.

Wei et al., "RMVPE: A Robust Model for Vocal Pitch Estimation in Polyphonic
Music" (arXiv:2306.15412), as Seed-VC's ``modules/rmvpe.py`` (from RVC)
runs it, at the released checkpoint's geometry by default (``E2E(4, 1,
(2, 2))``: 5 encoder levels of 4 residual conv blocks, 16 -> 256 channels,
4 x 4 intermediate blocks at 512, 5 decoder levels, a 3-channel conv, BiGRU
384 -> 2 x 256, 360 cents bins). Departures, all as the port and the JAX
package have them:

- the log-mel is zero-padded to a multiple of 32 frames after the log
  (``mel2hidden``), and both GRU directions run over the padded length
  before the crop; the reference file reflect-pads there in some versions;
- the STFT magnitude is ``sqrt(re^2 + im^2)`` with no epsilon and the mel
  filterbank librosa's (HTK scale, slaney norm), as the reference's
  ``MelSpectrogram``; the paper's front end is the same;
- the reference's ``nn.Dropout(0.25)`` after the linear layer is a no-op in
  inference and left out; BatchNorms run frozen on their running
  statistics;
- the GRU's two directions are two parameter sets named ``gru_fwd`` and
  ``gru_bwd`` (PyTorch's ``nn.GRU(bidirectional=True)`` names them
  ``weight_ih_l0`` and ``weight_ih_l0_reverse``), each with PyTorch's
  ``nn.GRU`` parameter names and gate order (r, z, n); the paper's figure
  draws one BiGRU;
- decoding pads the salience by 4 bins on each side, takes the argmax's
  +-4 bins, and zeroes frames whose peak is at most ``thred`` (0.03 as
  Seed-VC's inference calls it; the reference's default is 0.05).

Every product is f32; nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vcbench.ref.dsp.mel import hann_window, mel_filterbank
from vcbench.ref.dsp.stft import stft_magnitude

N_MELS = 128
N_CLASS = 360
N_FFT, HOP = 1024, 160
HIDDEN = 256
CENTS_MAPPING = 20 * np.arange(N_CLASS) + 1997.3794084376191


def rmvpe_mel(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, 1 + T // 160, 128) log-mel: Hann window 1024,
    hop 160, reflect-padded by 512 (center=True), 30-8000 Hz,
    ``log(max(mel, 1e-5))``."""
    y = F.pad(audio.float()[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    window = torch.from_numpy(hann_window(N_FFT)).to(y.device)
    mag = stft_magnitude(y, N_FFT, HOP, window, eps=0.0)
    basis = torch.from_numpy(
        mel_filterbank(16000, N_FFT, N_MELS, 30.0, 8000.0, htk=True).T).to(y.device)
    return torch.log(torch.clamp(mag @ basis, min=1e-5))


class ConvBlockRes(nn.Module):
    """(3x3 conv, no bias -> BN -> ReLU) twice, plus the input, through a 1x1
    conv (with bias) when the channel count changes."""

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


class GRU(nn.Module):
    """One GRU direction with ``nn.GRU``'s parameters, run as its equations,
    one frame at a time:

        r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
        z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
        n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
        h' = (1 - z) * n + z * h

    from h = 0; the input products of every frame are made in one product
    before the loop."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh_l0 = nn.Parameter(torch.empty(3 * hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, input_size) -> the states (B, T, hidden_size)."""
        H = self.hidden_size
        gi = F.linear(x, self.weight_ih_l0, self.bias_ih_l0)
        h = x.new_zeros(x.shape[0], H)
        out = []
        for t in range(x.shape[1]):
            gh = F.linear(h, self.weight_hh_l0, self.bias_hh_l0)
            i_r, i_z, i_n = gi[:, t].split(H, dim=-1)
            h_r, h_z, h_n = gh.split(H, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


class RMVPE_E2E(nn.Module):
    """The salience model (parameter names and order as the port's, so one
    seeded draw fills both)."""

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
        self.gru_fwd = GRU(3 * N_MELS, HIDDEN)
        self.gru_bwd = GRU(3 * N_MELS, HIDDEN)
        self.fc_linear = nn.Linear(2 * HIDDEN, N_CLASS)

    def unet(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, 128) -> the 3-channel map flattened channel-major,
        (B, T, 384): index c * 128 + f."""
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

    def bigru(self, h: torch.Tensor) -> torch.Tensor:
        """(B, T, 384) -> (B, T, 512): the forward scan's states, then the
        backward scan's, run over the time-reversed frames and put back in
        order."""
        return torch.cat([self.gru_fwd(h), self.gru_bwd(h.flip(1)).flip(1)], dim=-1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, 128), T a multiple of 2^en_de_layers -> salience
        (B, T, 360)."""
        return torch.sigmoid(self.fc_linear(self.bigru(self.unet(mel))))


def decode_f0(salience: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """(T, 360) salience -> (T,) F0 Hz: the reference's
    ``to_local_average_cents`` (the salience-weighted mean of the cents over
    the argmax's +-4 bins, 0 where the peak is at most ``thred``), then
    ``10 * 2^(cents / 1200)`` with 10 Hz read as unvoiced (0)."""
    center = np.argmax(salience, axis=1) + 4
    sal = np.pad(salience, ((0, 0), (4, 4)))
    cents = np.pad(CENTS_MAPPING, (4, 4))
    idx = center[:, None] + np.arange(-4, 5)[None, :]
    todo_sal = np.take_along_axis(sal, idx, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        devided = (todo_sal * cents[idx]).sum(1) / todo_sal.sum(1)
    devided[sal.max(axis=1) <= thred] = 0
    f0 = 10 * 2 ** (devided / 1200)
    f0[f0 == 10] = 0
    return f0


class RMVPE:
    """Mel + E2E + decoding around an :class:`RMVPE_E2E` on its device."""

    def __init__(self, model: RMVPE_E2E):
        self.model = model

    @torch.no_grad()
    def salience(self, audio_16k: np.ndarray) -> torch.Tensor:
        """(B, T) 16 kHz audio -> (B, n_frames, 360) f32."""
        dev = next(self.model.parameters()).device
        mel = rmvpe_mel(torch.as_tensor(np.asarray(audio_16k, np.float32)).to(dev))
        n_frames = mel.shape[1]
        mel = F.pad(mel, (0, 0, 0, -(-n_frames // 32) * 32 - n_frames))
        return self.model(mel)[:, :n_frames]

    def infer_from_audio(self, audio_16k: np.ndarray, thred: float = 0.03) -> np.ndarray:
        """(T,) 16 kHz audio -> (n_frames,) F0 Hz."""
        return decode_f0(self.salience(audio_16k[None])[0].float().cpu().numpy(), thred)
