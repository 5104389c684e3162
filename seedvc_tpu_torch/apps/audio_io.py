"""Minimal WAV read/write (scipy; no librosa or soundfile) and the audio-file
scan of the CLI's ``--source-dir``: copies of
``seedvc_tpu/apps/audio_io.py`` and of ``scan_audio_files`` / ``AUDIO_EXTS``
from ``seedvc_tpu/train/dataset.py``, the dataset module of the training
slice."""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

AUDIO_EXTS = (".wav", ".mp3", ".flac", ".ogg", ".m4a", ".opus")


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (float32 mono waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wave = data.astype(np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=1)
    return wave, sr


def save_wav(path: str, wave: np.ndarray, sr: int) -> None:
    wave = np.clip(wave, -1.0, 1.0)
    wavfile.write(path, sr, (wave * 32767.0).astype(np.int16))


def scan_audio_files(data_path: str) -> list[str]:
    """Every file under ``data_path`` with an audio extension, sorted; raises
    if there is none."""
    out = []
    for root, _, files in os.walk(data_path):
        for f in files:
            if f.lower().endswith(AUDIO_EXTS):
                out.append(os.path.join(root, f))
    out.sort()
    if not out:
        raise AssertionError(f"No audio files found under {data_path}")
    return out
