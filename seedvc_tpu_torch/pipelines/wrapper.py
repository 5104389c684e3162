"""SeedVCWrapper: one facade over both v1 model sets (port of
``seedvc_tpu/pipelines/wrapper.py``).

``convert_voice`` dispatches on ``f0_condition`` between the 22.05 kHz
``whisper_small_wavenet`` preset and the 44.1 kHz ``whisper_base_f0_44k``
SVC preset. Each converter is built on first use, on the wrapper's device,
and conversion streams crossfaded chunks.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from seedvc_tpu_torch.core.config import get_preset
from seedvc_tpu_torch.pipelines.convert import VoiceConverter

PRESET_BY_F0 = {False: "whisper_small_wavenet", True: "whisper_base_f0_44k"}


def load_params_dir(checkpoint_dir: Optional[str]) -> dict:
    """The converted parameter trees (pickled dicts of numpy arrays, as
    ``seedvc_tpu/apps/convert_checkpoint.py`` writes them) found in a
    directory, as ``VoiceConverter`` keyword arguments; a missing file leaves
    that model's weights random."""
    params: dict = {}
    if checkpoint_dir:
        for name in ("vc", "whisper", "campplus", "vocoder", "rmvpe"):
            path = os.path.join(checkpoint_dir, f"{name}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    params[f"{name}_params"] = pickle.load(f)
    return params


class SeedVCWrapper:
    """``device`` defaults to ``cuda`` and raises when there is none; pass
    ``device="cpu"`` to run the plain PyTorch twins of the kernels."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 checkpoint_dir_f0: Optional[str] = None, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SeedVCWrapper: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self._dirs = {False: checkpoint_dir, True: checkpoint_dir_f0}
        self._converters: dict[bool, VoiceConverter] = {}

    def converter(self, f0_condition: bool) -> VoiceConverter:
        if f0_condition not in self._converters:
            cfg = get_preset(PRESET_BY_F0[f0_condition])
            self._converters[f0_condition] = VoiceConverter(
                cfg, device=self.device, **load_params_dir(self._dirs[f0_condition]))
        return self._converters[f0_condition]

    def convert_voice(self, source, source_sr, target, target_sr, *,
                      f0_condition: bool = False, diffusion_steps: int = 25,
                      length_adjust: float = 1.0, inference_cfg_rate: float = 0.7,
                      auto_f0_adjust: bool = True, pitch_shift: float = 0.0,
                      seed: int = 0, stream_output: bool = True):
        """Generator over ``(sr, wave_chunk, stats)``; the model set is chosen
        by ``f0_condition``. With ``stream_output=False`` it yields one
        complete waveform."""
        conv = self.converter(f0_condition)
        gen = conv.convert_with_streaming(
            source, source_sr, target, target_sr, diffusion_steps=diffusion_steps,
            length_adjust=length_adjust, cfg_rate=inference_cfg_rate,
            auto_f0_adjust=auto_f0_adjust, pitch_shift=pitch_shift, seed=seed)
        if stream_output:
            yield from gen
            return
        chunks, stats, sr = [], {}, conv.sr
        for sr, piece, stats in gen:
            chunks.append(piece)
        out = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        yield sr, out, stats
