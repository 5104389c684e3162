"""Seeded singing-like audio: legato phrases between breath pauses.

A phrase (2-8 s by default) is a run of notes (0.2-1.5 s), each a pitch
inside the phrase's own two-octave range (its floor drawn so the range lies
in 100-900 Hz), joined by glides, with vibrato (4.5-6.5 Hz, +-2-4%) over
the whole phrase. The voice is a sawtooth at that pitch with a little
breath noise through three formant resonators whose centres change with
each note (a syllable), with 30 ms ramps at the phrase's ends; a pause
(0.2-1 s) is noise 70 dB down. The same seed gives the same samples; the
filtering is ``scipy.signal.lfilter``'s, so a two-minute clip takes a
fraction of a second.

The parameters come from a traffic file's ``audio`` object (keys as
:data:`DEFAULTS`).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

from vcbench.audio import _resonator

DEFAULTS = {
    "phrase_seconds": [2.0, 8.0],
    "note_seconds": [0.2, 1.5],
    "glide_seconds": [0.03, 0.12],
    "f0_hz": [100.0, 900.0],
    "octaves": 2.0,
    "vibrato_hz": [4.5, 6.5],
    "vibrato_depth": [0.02, 0.04],
    "pause_seconds": [0.2, 1.0],
    "pause_db": -70.0,
    "level_db": -18.0,
}
FORMANTS = ((300, 1000, 90), (900, 2600, 120), (2400, 3600, 180))


def _pitch(n: int, sr: int, g: np.random.Generator, p: dict) -> np.ndarray:
    """One phrase's F0 (Hz) a sample: notes in a two-octave range, glides
    between them (a raised cosine in log-F0), vibrato on top. Also returns
    each note's first sample."""
    lo_hz, hi_hz = p["f0_hz"]
    span = 2.0 ** p["octaves"]
    floor = g.uniform(lo_hz, hi_hz / span)
    starts, logs, pos = [], [], 0
    while pos < n:
        starts.append(pos)
        logs.append(np.log(floor) + g.uniform(0, np.log(span)))
        pos += max(int(g.uniform(*p["note_seconds"]) * sr), 1)
    log_f0 = np.empty(n)
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else n
        log_f0[s:e] = logs[i]
        if i:
            k = min(int(g.uniform(*p["glide_seconds"]) * sr), e - s)
            ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(k) / max(k, 1))
            log_f0[s: s + k] = logs[i - 1] + (logs[i] - logs[i - 1]) * ramp
    t = np.arange(n) / sr
    vib = 1.0 + g.uniform(*p["vibrato_depth"]) * np.sin(
        2 * np.pi * g.uniform(*p["vibrato_hz"]) * t + g.uniform(0, 2 * np.pi))
    return np.exp(log_f0) * vib, starts


def _phrase(n: int, sr: int, g: np.random.Generator, p: dict) -> np.ndarray:
    f0, starts = _pitch(n, sr, g, p)
    phase = np.cumsum(f0 / sr)
    x = 2 * (phase - np.floor(phase)) - 1 + 0.03 * g.standard_normal(n)
    y = np.zeros(n)
    zi = [np.zeros(2) for _ in FORMANTS]
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else n
        for j, (lo_f, hi_f, bw) in enumerate(FORMANTS):
            b, a = _resonator(g.uniform(lo_f, min(hi_f, 0.45 * sr)), bw, sr)
            seg, zi[j] = lfilter(b, a, x[s:e], zi=zi[j])
            y[s:e] += seg
    ramp = min(int(0.03 * sr), n // 2)
    if ramp:
        y[:ramp] *= np.linspace(0, 1, ramp)
        y[n - ramp:] *= np.linspace(1, 0, ramp)
    return y * (10 ** (p["level_db"] / 20) / max(np.abs(y).max(), 1e-9))


def singing_like(seconds: float, sr: int, g: np.random.Generator,
                 params: dict | None = None) -> np.ndarray:
    """``seconds`` of f32 audio at ``sr`` from the generator ``g``: phrases
    and pauses in turn, a phrase first."""
    p = {**DEFAULTS, **(params or {})}
    n = max(int(round(seconds * sr)), 1)
    out = np.zeros(n, np.float32)
    pos, voiced = 0, True
    while pos < n:
        lo, hi = p["phrase_seconds"] if voiced else p["pause_seconds"]
        m = min(max(int(g.uniform(lo, hi) * sr), 1), n - pos)
        out[pos: pos + m] = (_phrase(m, sr, g, p) if voiced
                             else 10 ** (p["pause_db"] / 20) * g.standard_normal(m))
        pos += m
        voiced = not voiced
    return out
