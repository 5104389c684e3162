"""Host-side polyphase resampling for pipeline pre-processing."""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly


def resample_host(wave, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy), as the JAX pipeline does it:
    decimating the source before it reaches the device."""
    if orig_sr == new_sr:
        return np.asarray(wave, np.float32)
    g = math.gcd(orig_sr, new_sr)
    out = resample_poly(np.asarray(wave, np.float32), new_sr // g,
                        orig_sr // g, axis=-1)
    return out.astype(np.float32)
