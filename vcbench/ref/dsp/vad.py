"""Classical voice-activity detection (energy + spectral flatness): a copy of
``seedvc_tpu/dsp/vad.py``.

The reference gates audio with external neural VADs — funasr fsmn-vad in
the real-time GUI (``real-time-gui.py:439-440``, ``:1013-1021``) and
whisper/silero segmentation in OpenVoice's ``se_extractor.py`` — whose
checkpoints are not redistributable here.  This module is the built-in
substitute: a G.729B-style dual-feature detector,

- adaptive noise floor: energy percentile over the utterance,
- voiced = (energy above floor + margin) AND (spectral flatness below a
  threshold — speech is harmonic/low-flatness, broadband noise is ~1.0),
- hangover smoothing: short gaps are bridged and decisions extended a few
  frames so plosives/stops are not chopped.

Pure numpy (host-side; runs on ~50 ms frames, negligible next to model
time).
"""

from __future__ import annotations

import numpy as np


def frame_features(wave: np.ndarray, sr: int,
                   frame_sec: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame (energy_db, spectral_flatness) for a mono waveform."""
    frame = max(int(frame_sec * sr), 32)
    n = len(wave) // frame
    if n == 0:
        return (np.full((1,), -100.0, np.float32),
                np.ones((1,), np.float32))
    frames = wave[: n * frame].reshape(n, frame).astype(np.float64)
    energy_db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
    win = np.hanning(frame)
    spec = np.abs(np.fft.rfft(frames * win, axis=1)) ** 2
    # Smooth over adjacent bins before the flatness ratio: a single
    # periodogram bin is chi^2(2)-distributed, which biases the geometric
    # mean of even white noise down to ~0.56; 8-bin averaging restores
    # flatness ~0.93 for broadband noise while tones stay near 0.
    k = 8
    pad = (-spec.shape[1]) % k
    sm = np.pad(spec, ((0, 0), (0, pad)), mode="edge")
    sm = sm.reshape(n, -1, k).mean(axis=2) + 1e-12
    # geometric / arithmetic mean of the power spectrum in the speech band
    lo = max(0, int(100 * frame / sr) // k)
    hi = max(lo + 1, min(sm.shape[1], int(4000 * frame / sr) // k + 1))
    band = sm[:, lo:hi]
    flat = np.exp(np.mean(np.log(band), axis=1)) / np.mean(band, axis=1)
    return energy_db.astype(np.float32), flat.astype(np.float32)


def vad_decisions(wave: np.ndarray, sr: int, *,
                  frame_sec: float = 0.05,
                  energy_margin_db: float = 12.0,
                  abs_floor_db: float = -55.0,
                  flatness_max: float = 0.5,
                  hangover_frames: int = 3,
                  bridge_frames: int = 4) -> np.ndarray:
    """Boolean per-frame voiced decisions with hangover smoothing."""
    energy_db, flat = frame_features(wave, sr, frame_sec)
    # Adaptive floor: 10th-percentile energy + margin, but never above
    # 6 dB under the loud-frame level (signals with no silent frames would
    # otherwise push the floor to speech level and gate everything off),
    # and never below the absolute floor.
    noise_floor = max(float(np.percentile(energy_db, 10.0)), -80.0)
    loud = float(np.percentile(energy_db, 95.0))
    thr = max(min(noise_floor + energy_margin_db, loud - 6.0), abs_floor_db)
    voiced = (energy_db > thr) & (flat < flatness_max)

    if not voiced.any():
        return voiced
    # bridge short unvoiced gaps
    idx = np.flatnonzero(voiced)
    out = voiced.copy()
    for a, b in zip(idx[:-1], idx[1:]):
        if 1 < b - a <= bridge_frames + 1:
            out[a:b] = True
    # hangover: extend each voiced run forward
    if hangover_frames > 0:
        ext = np.zeros_like(out)
        for k in range(hangover_frames + 1):
            ext[k:] |= out[: len(out) - k if k else None]
        out = ext
    return out


def split_segments(wave: np.ndarray, sr: int, *,
                   frame_sec: float = 0.05,
                   min_sec: float = 1.5,
                   max_sec: float = 10.0,
                   **vad_kw) -> list[np.ndarray]:
    """Split a waveform into voiced segments (the reference se_extractor's
    gating policy: pieces between min_sec and max_sec; whole utterance as
    fallback when nothing passes)."""
    frame = max(int(frame_sec * sr), 32)
    voiced = vad_decisions(wave, sr, frame_sec=frame_sec, **vad_kw)

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


def is_speech_block(block: np.ndarray, sr: int, *,
                    threshold_db: float = -60.0,
                    flatness_max: float = 0.8) -> bool:
    """Single-block decision for the streaming gate (fsmn-vad substitute).

    Cheap dual check: mean energy above the absolute threshold AND the
    block's spectral flatness below ``flatness_max`` (rejects broadband
    noise that a pure RMS gate passes).  flatness_max is deliberately loose
    (0.8): sustained unvoiced fricatives ('s', 'sh', 'f') are broadband too
    (smoothed flatness ~0.5-0.7) and must not be gated to silence mid-word,
    while white/pink noise still measures ~0.9+ after the periodogram
    smoothing in :func:`frame_features`.  The streaming pipeline adds a
    2-block hangover on top (pipelines/streaming.py).
    """
    rms_db = 10.0 * np.log10(float(np.mean(block ** 2)) + 1e-12)
    if rms_db < threshold_db:
        return False
    _, flat = frame_features(block, sr, frame_sec=len(block) / sr)
    return float(flat[0]) < flatness_max
