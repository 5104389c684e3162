"""SOLA alignment and crossfade for the streaming pipeline (port of
``seedvc_tpu/dsp/sola.py``).

The DDSP-SVC SOLA of the reference real-time GUI: the normalised
cross-correlation of the new chunk's head against the previous tail, its
argmax offset within the search window, then an equal-power sin^2 fade
join. Each function runs in the repo's native C++ library
(``native/seedvc_native.cpp``) when it loads, else in numpy with the same
math.

The library is loaded read-only from ``native/libseedvc_native.so``. If that
file is missing or does not load, the source is compiled with ``g++`` into
``build/native/`` (git-ignored); nothing is ever written into ``native/``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"

_lib: ctypes.CDLL | None = None
_tried = False


def _bind(path: Path) -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.sola_offset.restype = ctypes.c_int
    lib.sola_offset.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int, ctypes.c_int]
    lib.crossfade_add.restype = None
    lib.crossfade_add.argtypes = [fp, fp, fp, fp, ctypes.c_int]
    lib.ring_shift_append.restype = None
    lib.ring_shift_append.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int]
    return lib


def _build() -> Path | None:
    """Compile ``native/seedvc_native.cpp`` into ``build/native/``; None if
    there is no source or no ``g++``, or the compile fails."""
    src, gxx = NATIVE_DIR / "seedvc_native.cpp", shutil.which("g++")
    if not src.exists() or gxx is None:
        return None
    out = BUILD_DIR / "libseedvc_native.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-o", str(out), str(src)],
                          capture_output=True)
    return out if done.returncode == 0 else None


def load_native() -> ctypes.CDLL | None:
    """The native library, loaded once per process, or None (numpy path)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        prebuilt = NATIVE_DIR / "libseedvc_native.so"
        _lib = _bind(prebuilt) if prebuilt.exists() else None
        if _lib is None:
            built = _build()
            _lib = _bind(built) if built is not None else None
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sola_offset(chunk: np.ndarray, sola_buf: np.ndarray, search_len: int,
                use_native: bool = True) -> int:
    """argmax_k corr(chunk[k:k+n], sola_buf) / sqrt(energy), k in [0, search]."""
    chunk = np.ascontiguousarray(chunk, np.float32)
    sola_buf = np.ascontiguousarray(sola_buf, np.float32)
    n = len(sola_buf)
    lib = load_native() if use_native else None
    if lib is not None:
        return int(lib.sola_offset(_fp(chunk), len(chunk), _fp(sola_buf), n, search_len))
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


def crossfade_add(chunk: np.ndarray, prev_tail: np.ndarray,
                  use_native: bool = True) -> np.ndarray:
    """Fade the head of ``chunk`` against ``prev_tail`` in place; returns chunk."""
    n = len(prev_tail)
    chunk = np.ascontiguousarray(chunk, np.float32)
    fade_in, fade_out = fade_windows(n)
    lib = load_native() if use_native else None
    if lib is not None:
        lib.crossfade_add(_fp(chunk), _fp(np.ascontiguousarray(prev_tail, np.float32)),
                          _fp(fade_in), _fp(fade_out), n)
        return chunk
    chunk[:n] = chunk[:n] * fade_in + prev_tail * fade_out
    return chunk


def ring_shift_append(ring: np.ndarray, block: np.ndarray,
                      use_native: bool = True) -> np.ndarray:
    """Drop ``len(block)`` samples from the front of ``ring`` and append
    ``block``, in place; returns ring."""
    ring = np.ascontiguousarray(ring, np.float32)
    block = np.ascontiguousarray(block, np.float32)
    lib = load_native() if use_native else None
    if lib is not None:
        lib.ring_shift_append(_fp(ring), len(ring), _fp(block), len(block))
        return ring
    if len(block) >= len(ring):
        ring[:] = block[-len(ring):]
    else:
        ring[:-len(block)] = ring[len(block):]
        ring[-len(block):] = block
    return ring
