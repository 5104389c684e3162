"""Seeded speech-like audio: voiced talk spurts between quiet pauses.

A spurt is a sawtooth at a wandering pitch (90-260 Hz) through three formant
resonators whose centres change with each spurt, with a little breath noise
and 20 ms ramps; a pause is noise 70 dB down, below the stream's -60 dB voice
gate. The same seed gives the same samples. Everything is filtered in C
(``scipy.signal.lfilter``), so a two-minute clip takes a fraction of a
second.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def _resonator(f: float, bw: float, sr: int):
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * f / sr
    return [1.0 - r], [1.0, -2 * r * np.cos(theta), r * r]


def speech_like(seconds: float, sr: int, g: np.random.Generator, *,
                spurt=(1.0, 4.0), pause=(0.3, 2.0), level_db: float = -18.0,
                start_voiced: bool = True) -> np.ndarray:
    """``seconds`` of f32 audio at ``sr`` from the generator ``g``."""
    n = max(int(round(seconds * sr)), 1)
    out = np.zeros(n, np.float32)
    pos, voiced = 0, start_voiced
    peak = 10 ** (level_db / 20)
    while pos < n:
        lo, hi = spurt if voiced else pause
        m = min(int(g.uniform(lo, hi) * sr), n - pos)
        if voiced:
            t = np.arange(m) / sr
            f0 = g.uniform(90, 260) * (1 + 0.15 * np.sin(2 * np.pi * g.uniform(0.5, 3) * t
                                                         + g.uniform(0, 6.28)))
            phase = np.cumsum(f0 / sr)
            x = 2 * (phase - np.floor(phase)) - 1
            x += 0.05 * g.standard_normal(m)
            y = np.zeros(m)
            for lo_f, hi_f, bw in ((300, 900, 90), (900, 2500, 120), (2500, 3500, 180)):
                b, a = _resonator(g.uniform(lo_f, min(hi_f, 0.45 * sr)), bw, sr)
                y += lfilter(b, a, x)
            ramp = min(int(0.02 * sr), m // 2)
            env = np.ones(m)
            if ramp:
                env[:ramp] = np.linspace(0, 1, ramp)
                env[m - ramp:] = np.linspace(1, 0, ramp)
            y *= env
            y *= peak / max(np.abs(y).max(), 1e-9)
        else:
            y = 10 ** (-70 / 20) * g.standard_normal(m)
        out[pos: pos + m] = y
        pos += m
        voiced = not voiced
    return out
