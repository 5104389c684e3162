"""Fine-tuning dataset: a directory of audio -> padded training batches
(port of ``seedvc_tpu/train/dataset.py``).

- recursive scan for audio files (``apps/audio_io.py::scan_audio_files``),
- duration filter 1-30 s; a bad or out-of-range file is replaced by another
  index picked deterministically from an md5 hash of (index, count, path),
- host-side resampling to the model rate and to 16 kHz (for the frozen
  encoders), cached per item up to ``cache_bytes``,
- collate zero-pads the waves; mels are computed in the trainer, on the
  device, and padded with -10 there.

``batches(shuffle, epoch)`` gives the order the JAX package gives on the same
directory (numpy's ``default_rng(seed + epoch)`` shuffle).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from seedvc_tpu_torch.apps.audio_io import load_wav, scan_audio_files
from seedvc_tpu_torch.dsp.resample import resample_host

MIN_SEC, MAX_SEC = 1.0, 30.0


@dataclass
class Batch:
    waves: np.ndarray        # (B, T) at the model rate, zero-padded
    waves_16k: np.ndarray    # (B, T16) at 16 kHz, zero-padded
    wave_lengths: np.ndarray
    wave_16k_lengths: np.ndarray
    # dataset item indices (keys of the trainer's per-clip feature cache);
    # None for batches built outside FTDataset
    ids: np.ndarray | None = None


class FTDataset:
    def __init__(self, data_path: str, sr: int, batch_size: int,
                 max_samples_sec: float = MAX_SEC, seed: int = 1234,
                 cache_bytes: int = 2 << 30):
        self.files = scan_audio_files(data_path)
        while len(self.files) < batch_size:
            self.files = self.files + self.files
        self.sr = sr
        self.batch_size = batch_size
        self.max_sec = max_samples_sec
        self.seed = seed
        self.cache_bytes = cache_bytes
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._cache_used = 0

    def __len__(self):
        return len(self.files)

    def _deterministic_replacement(self, idx: int, path: str) -> int:
        h = hashlib.md5(f"{idx}_{len(self)}_{path}".encode()).hexdigest()
        j = int(h, 16) % len(self)
        return j if j != idx else (idx + 1) % len(self)

    def load_item(self, idx: int, _depth: int = 0) -> tuple[np.ndarray, int]:
        path = self.files[idx]
        try:
            wave, orig_sr = load_wav(path)
        except (OSError, ValueError):
            wave, orig_sr = None, 0
        bad = (wave is None or not np.isfinite(wave).all()
               or len(wave) < orig_sr * MIN_SEC or len(wave) > orig_sr * self.max_sec)
        if bad:
            if _depth > 10:
                raise RuntimeError(f"too many bad files around index {idx}")
            return self.load_item(self._deterministic_replacement(idx, path), _depth + 1)
        return wave, orig_sr

    def _load_resampled(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(wave at the model rate, wave at 16 kHz) of one item, resampled on
        the host and cached while the cache has room."""
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        w, osr = self.load_item(idx)
        item = (resample_host(w, osr, self.sr), resample_host(w, osr, 16000))
        size = item[0].nbytes + item[1].nbytes
        if self._cache_used + size <= self.cache_bytes:
            self._cache[idx] = item
            self._cache_used += size
        return item

    def batches(self, shuffle: bool = True, epoch: int = 0) -> Iterator[Batch]:
        order = np.arange(len(self.files))
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
            idxs = order[start: start + self.batch_size]
            waves, waves16 = zip(*(self._load_resampled(int(i)) for i in idxs))
            B = len(waves)
            out_w = np.zeros((B, max(len(w) for w in waves)), np.float32)
            out_w16 = np.zeros((B, max(len(w) for w in waves16)), np.float32)
            lens = np.zeros(B, np.int32)
            lens16 = np.zeros(B, np.int32)
            for b, (w, w16) in enumerate(zip(waves, waves16)):
                out_w[b, : len(w)] = w
                out_w16[b, : len(w16)] = w16
                lens[b] = len(w)
                lens16[b] = len(w16)
            yield Batch(out_w, out_w16, lens, lens16, ids=np.asarray(idxs, np.int64))
