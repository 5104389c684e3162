"""OpenVoice ToneColorConverter, the VITS flow-based timbre shifter (port of
``seedvc_tpu/models/openvoice.py``), computed in f32.

- linear-spectrogram frontend (hann, center=False, reflect pad
  (n_fft - hop) / 2, eps 1e-6),
- ReferenceEncoder: 6 stride-2 ``Conv2d``s over (time, freq), a channel-major
  flatten, a 128-wide ``nn.GRU`` whose last output is projected to the
  speaker embedding,
- posterior encoder: 1x1 pre -> zero-padded WaveNet -> mean / log-std,
  sampled with temperature tau from an explicit ``noise`` argument,
- flow: 4 mean-only affine couplings, each followed by a channel flip; the
  reverse flow runs the couplings in reverse order and un-flips before each,
- HiFi-GAN decoder with leaky-ReLU ResBlock1s and global conditioning; the
  last leaky ReLU has slope 0.01 and ``conv_post`` no bias,
- ``voice_conversion``: z = enc_q(spec) -> flow(g_src) -> flow^-1(g_tgt) ->
  dec. With ``zero_g`` (the shipped converter) enc_q and dec get zero
  conditioning, so g acts only through the flow.

The JAX package writes the GRU as a ``lax.scan``, the WaveNet convolutions as
shifted matmuls and the transposed convolutions as phase matmuls (TPU
rewrites); here they are ``nn.GRU``, ``Conv1d`` and ``ConvTranspose1d`` with
the same weights. Nothing here runs a kernel of the port. Submodule names
follow the flax tree (``ref_enc/convs_i``, ``enc_q_wn``, ``flow/flows_i``,
``dec/ups_i``, ...). Public layout: spec (B, T, spec_channels) in, wave
(B, T * 256) out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from seedvc_tpu_torch.dsp.mel import hann_window
from seedvc_tpu_torch.dsp.stft import stft_magnitude
from seedvc_tpu_torch.nn.wavenet import WaveNet


@dataclass(frozen=True)
class OpenVoiceConfig:
    spec_channels: int = 513
    inter_channels: int = 192
    hidden_channels: int = 192
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    gin_channels: int = 256
    zero_g: bool = True
    n_fft: int = 1024
    hop: int = 256


def linear_spectrogram(y: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """(B, T) -> (B, frames, n_fft // 2 + 1); VITS ``spectrogram_torch``
    semantics."""
    pad = (n_fft - hop) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.from_numpy(hann_window(n_fft)).to(y.device)
    return stft_magnitude(y, n_fft, hop, window, eps=1e-6)


class ReferenceEncoder(nn.Module):
    CHANNELS = (32, 32, 64, 64, 128, 128)

    def __init__(self, cfg: OpenVoiceConfig):
        super().__init__()
        in_ch, freq = 1, cfg.spec_channels
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"convs_{i}", nn.Conv2d(in_ch, ch, 3, stride=2, padding=1))
            in_ch, freq = ch, (freq - 1) // 2 + 1
        self.gru = nn.GRU(in_ch * freq, 128, batch_first=True)
        self.proj = nn.Linear(128, cfg.gin_channels)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """spec: (B, T, spec_channels) -> (B, gin_channels)."""
        h = spec[:, None]  # (B, 1, T, F)
        for i in range(len(self.CHANNELS)):
            h = F.relu(getattr(self, f"convs_{i}")(h))
        B, C, T, Fr = h.shape
        # channel-major flatten of each frame, as the reference's torch view
        h = h.permute(0, 2, 1, 3).reshape(B, T, C * Fr)
        ys, _ = self.gru(h)
        return self.proj(ys[:, -1])


class CouplingLayer(nn.Module):
    """Mean-only affine coupling over the channel halves. ``post`` starts at
    zero, as in the JAX module: a fresh flow is the identity, and g has no
    effect until ``post`` is trained or loaded."""

    def __init__(self, channels: int, hidden: int, gin_channels: int):
        super().__init__()
        self.half = half = channels // 2
        self.pre = nn.Linear(half, hidden)
        self.enc = WaveNet(hidden, kernel_size=5, dilation_rate=1, n_layers=4,
                           gin_channels=gin_channels, pad_mode="zero")
        self.post = nn.Linear(hidden, half)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x, x_mask, g, reverse: bool):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=-1)


class Flow(nn.Module):
    def __init__(self, cfg: OpenVoiceConfig, n_flows: int = 4):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"flows_{i}", CouplingLayer(
                cfg.inter_channels, cfg.hidden_channels, cfg.gin_channels))

    def forward(self, x, x_mask, g, reverse: bool = False):
        if reverse:
            for i in reversed(range(self.n_flows)):
                x = torch.flip(x, dims=(-1,))  # undo the flip after the coupling
                x = getattr(self, f"flows_{i}")(x, x_mask, g, reverse=True)
        else:
            for i in range(self.n_flows):
                x = getattr(self, f"flows_{i}")(x, x_mask, g, reverse=False)
                x = torch.flip(x, dims=(-1,))
        return x


class LeakyResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d, padding=(kernel_size - 1) // 2 * d))
            self.add_module(f"convs2_{i}", nn.Conv1d(
                channels, channels, kernel_size, padding=(kernel_size - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T), channels-first."""
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(F.leaky_relu(x, 0.1))
            x = x + getattr(self, f"convs2_{i}")(F.leaky_relu(h, 0.1))
        return x


class OpenVoiceDecoder(nn.Module):
    def __init__(self, cfg: OpenVoiceConfig):
        super().__init__()
        self.cfg = c = cfg
        ch = c.upsample_initial_channel
        self.conv_pre = nn.Conv1d(c.inter_channels, ch, 7, padding=3)
        self.cond = nn.Linear(c.gin_channels, ch)
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            if k - 2 * ((k - u) // 2) != u:
                raise ValueError(f"upsample {i}: kernel {k} and stride {u} do not give T*u frames")
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(
                ch, ch // 2, k, stride=u, padding=(k - u) // 2))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i}_{j}", LeakyResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """x: (B, T, inter), g: (B, gin) -> (B, T * prod(upsample_rates))."""
        c = self.cfg
        h = self.conv_pre(x.transpose(1, 2)) + self.cond(g)[:, :, None]
        n_res = len(c.resblock_kernel_sizes)
        for i in range(len(c.upsample_rates)):
            h = getattr(self, f"ups_{i}")(F.leaky_relu(h, 0.1))
            hs = getattr(self, f"resblocks_{i}_0")(h)
            for j in range(1, n_res):
                hs = hs + getattr(self, f"resblocks_{i}_{j}")(h)
            h = hs / n_res
        h = self.conv_post(F.leaky_relu(h, 0.01))
        return torch.tanh(h)[:, 0]


class ToneColorConverter(nn.Module):
    """The SynthesizerTrn subset used for voice conversion."""

    def __init__(self, cfg: OpenVoiceConfig = OpenVoiceConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.ref_enc = ReferenceEncoder(c)
        self.enc_q_pre = nn.Linear(c.spec_channels, c.hidden_channels)
        self.enc_q_wn = WaveNet(c.hidden_channels, kernel_size=5, dilation_rate=1, n_layers=16,
                                gin_channels=c.gin_channels, pad_mode="zero")
        self.enc_q_proj = nn.Linear(c.hidden_channels, c.inter_channels * 2)
        self.flow = Flow(c)
        self.dec = OpenVoiceDecoder(c)

    def extract_se(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, T, spec_channels) -> (B, gin) speaker embedding."""
        return self.ref_enc(spec)

    def voice_conversion(self, spec, spec_lens, g_src, g_tgt, noise, tau: float = 0.3):
        """spec (B, T, spec_channels), spec_lens (B,), g_src / g_tgt (B, gin),
        noise (B, T, inter) standard normal -> the converted wave
        (B, T * prod(upsample_rates))."""
        c = self.cfg
        T = spec.shape[1]
        mask = (torch.arange(T, device=spec.device)[None, :]
                < spec_lens[:, None])[..., None].to(spec.dtype)
        g_enc = torch.zeros_like(g_src) if c.zero_g else g_src
        h = self.enc_q_pre(spec) * mask
        h = self.enc_q_wn(h, mask, g=g_enc[:, None, :])
        m, logs = torch.chunk(self.enc_q_proj(h) * mask, 2, dim=-1)
        z = (m + noise * tau * torch.exp(logs)) * mask
        z_p = self.flow(z, mask, g_src[:, None, :], reverse=False)
        z_hat = self.flow(z_p, mask, g_tgt[:, None, :], reverse=True)
        g_dec = torch.zeros_like(g_tgt) if c.zero_g else g_tgt
        return self.dec(z_hat * mask, g_dec)


def draw_post(model: ToneColorConverter) -> ToneColorConverter:
    """Draw each coupling's ``post`` from the global torch generator, for runs
    at random weights: its init is zero, which leaves the flow the identity
    and the speaker embeddings without effect."""
    for i in range(model.flow.n_flows):
        getattr(model.flow, f"flows_{i}").post.reset_parameters()
    return model


# ---------------------------------------------------------------------------
# Speaker-embedding extraction over voiced segments (host-side utility), a copy
# of the JAX module's: ``get_se`` averages the ReferenceEncoder embedding over
# the segments of the classical VAD (``dsp/vad.py``), the built-in substitute
# for the reference's whisper/silero segmentation.
# ---------------------------------------------------------------------------

def split_segments_by_energy(wave: np.ndarray, sr: int, *, frame_sec: float = 0.05,
                             threshold_db: float = -40.0, min_sec: float = 1.5,
                             max_sec: float = 10.0) -> list[np.ndarray]:
    """Split a waveform into voiced segments by frame RMS energy: pieces
    between ``min_sec`` and ``max_sec`` long, or the whole utterance when
    nothing passes the gate."""
    frame = max(int(frame_sec * sr), 1)
    n_frames = len(wave) // frame
    if n_frames == 0:
        return [wave]
    frames = wave[: n_frames * frame].reshape(n_frames, frame)
    rms_db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
    voiced = rms_db > threshold_db

    segments: list[np.ndarray] = []
    start = None
    for i, v in enumerate(np.concatenate([voiced, [False]])):
        if v and start is None:
            start = i
        elif not v and start is not None:
            seg = wave[start * frame: i * frame]
            start = None
            max_len = int(max_sec * sr)
            for off in range(0, len(seg), max_len):
                piece = seg[off: off + max_len]
                if len(piece) >= min_sec * sr:
                    segments.append(piece)
    return segments or [wave]


def get_se(wave: np.ndarray, sr: int, extract_fn: Callable, *, spec_sr: int = 22050,
           vad: bool = True, device="cuda") -> np.ndarray:
    """Average speaker embedding over the (optionally VAD-split) segments.
    The wave is resampled to ``spec_sr`` on ``device`` (default cuda; raises
    without a card unless given ``device="cpu"``); ``extract_fn(spec)`` maps a
    (1, T, spec_channels) linear spectrogram on ``device`` to a (1, gin)
    embedding, typically ``ToneColorConverter.extract_se``."""
    from seedvc_tpu_torch.dsp.resample import resample
    from seedvc_tpu_torch.dsp.vad import split_segments

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_se: no CUDA device; pass device='cpu'")
    if sr != spec_sr:
        wave = resample(torch.from_numpy(np.asarray(wave, np.float32)).to(device), sr,
                        spec_sr).cpu().numpy()
        sr = spec_sr
    segments = split_segments(wave, sr) if vad else [wave]
    embs = []
    for seg in segments:
        spec = linear_spectrogram(torch.from_numpy(np.asarray(seg, np.float32)[None]).to(device))
        emb = extract_fn(spec)
        if isinstance(emb, torch.Tensor):
            emb = emb.detach().cpu().numpy()
        embs.append(np.asarray(emb)[0])
    return np.mean(np.stack(embs), axis=0)
