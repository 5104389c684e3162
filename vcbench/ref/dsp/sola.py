"""SOLA alignment and crossfade for the streaming pipeline, in numpy.

The DDSP-SVC SOLA of the reference real-time GUI: the normalised
cross-correlation of the new chunk's head against the previous tail, its
argmax offset within the search window, then an equal-power sin^2 fade
join.
"""

from __future__ import annotations

import numpy as np


def sola_offset(chunk: np.ndarray, sola_buf: np.ndarray, search_len: int) -> int:
    """argmax_k corr(chunk[k:k+n], sola_buf) / sqrt(energy), k in [0, search],
    the sums in float64 (two offsets within float32's rounding of each other
    would otherwise be ordered by it)."""
    chunk = np.asarray(chunk, np.float64)
    sola_buf = np.asarray(sola_buf, np.float64)
    n = len(sola_buf)
    max_k = min(search_len, len(chunk) - n)
    windows = np.lib.stride_tricks.sliding_window_view(chunk, n)[: max_k + 1]
    dots = windows @ sola_buf
    energies = (windows ** 2).sum(axis=1)
    return int(np.argmax(dots / np.sqrt(energies + 1e-8)))


def fade_windows(n: int) -> tuple[np.ndarray, np.ndarray]:
    """sin^2 fade-in and the complementary fade-out."""
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    fade_in = np.sin(0.5 * np.pi * t) ** 2
    return fade_in, 1.0 - fade_in


def crossfade_add(chunk: np.ndarray, prev_tail: np.ndarray) -> np.ndarray:
    """Fade the head of ``chunk`` against ``prev_tail`` in place; returns chunk."""
    n = len(prev_tail)
    chunk = np.ascontiguousarray(chunk, np.float32)
    fade_in, fade_out = fade_windows(n)
    chunk[:n] = chunk[:n] * fade_in + prev_tail * fade_out
    return chunk
