"""Baseline voice-conversion adapters for the eval harness (port of
``seedvc_tpu/apps/baselines.py``). Each exposes
``convert(source_path, reference_path, output_path)``:

- :class:`OpenVoiceBaseline` runs the port's ToneColorConverter
  (``models/openvoice.py``) from a flax-layout ``openvoice.pkl``, on an
  explicit device;
- :class:`CosyVoiceBaseline` runs CosyVoice-300M-25Hz from a CosyVoice
  checkout the caller names (gated: raises without one);
- :class:`CommandBaseline` runs any external converter as a subprocess from a
  ``{source} {reference} {output}`` command template.
"""

from __future__ import annotations

import os
import pickle
import shlex
import subprocess
import sys
from typing import Callable, Optional

import numpy as np
import torch

from seedvc_tpu_torch.apps.audio_io import load_wav, save_wav
from seedvc_tpu_torch.dsp.resample import resample


class OpenVoiceBaseline:
    """Timbre-only conversion with the OpenVoice VITS flow: the source's and
    the reference's speaker embeddings from their linear spectrograms at
    22.05 kHz, then ``voice_conversion`` at ``tau``.

    The posterior noise (1, frames, inter) comes from ``noise_fn(shape)`` (a
    CPU tensor), by default a ``torch.Generator`` seeded 0 on every call; the
    JAX adapter draws it from ``PRNGKey(0)`` on every call (ROADMAP queue 3:
    the same noise on every call, other values)."""

    SR = 22050

    def __init__(self, checkpoint_pkl: str, tau: float = 0.3, device="cuda",
                 noise_fn: Optional[Callable] = None):
        from seedvc_tpu_torch.models.openvoice import OpenVoiceConfig, ToneColorConverter
        from seedvc_tpu_torch.weights import load_jax_params

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OpenVoiceBaseline: no CUDA device; pass device='cpu'")
        if self.device.type == "cuda":  # the converter is specified at f32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        with open(checkpoint_pkl, "rb") as f:
            tree = pickle.load(f)
        self.model = load_jax_params(ToneColorConverter(OpenVoiceConfig()), tree)
        self.model.requires_grad_(False).eval().to(self.device)
        self.tau = tau
        self.noise_fn = noise_fn or (lambda shape: torch.randn(
            shape, generator=torch.Generator().manual_seed(0)))

    @torch.no_grad()
    def convert(self, source_path: str, reference_path: str, output_path: str) -> str:
        from seedvc_tpu_torch.models.openvoice import linear_spectrogram

        def spec_of(path):
            wave, sr = load_wav(path)
            wave = resample(torch.from_numpy(wave).to(self.device), sr, self.SR)
            return linear_spectrogram(wave[None])

        spec_src, spec_ref = spec_of(source_path), spec_of(reference_path)
        m = self.model
        T = spec_src.shape[1]
        noise = self.noise_fn((1, T, m.cfg.inter_channels)).to(self.device)
        out = m.voice_conversion(spec_src, torch.tensor([T], device=self.device),
                                 m.extract_se(spec_src), m.extract_se(spec_ref), noise, self.tau)
        save_wav(output_path, out[0].cpu().numpy(), self.SR)
        return output_path


class CosyVoiceBaseline:
    """CosyVoice-300M-25Hz VC through a CosyVoice checkout that the caller
    names (the reference's ``baselines/cosyvoice.py``: ``repo_dir`` and its
    Matcha-TTS on ``sys.path``, ``CosyVoice(...).inference_vc``). Raises if
    the checkout or its package is absent, and then leaves ``sys.path`` as it
    was."""

    def __init__(self, repo_dir: str, model_dir: str = "pretrained_models/CosyVoice-300M-25Hz"):
        paths = [repo_dir, os.path.join(repo_dir, "third_party", "Matcha-TTS")]
        missing = RuntimeError(
            f"CosyVoice baseline needs a checkout at {repo_dir!r} "
            "(github.com/FunAudioLLM/CosyVoice) with the "
            "CosyVoice-300M-25Hz model downloaded")
        if not os.path.isdir(repo_dir):
            raise missing
        sys.path.extend(paths)
        try:
            from cosyvoice.cli.cosyvoice import CosyVoice
        except ImportError as e:
            for p in paths:
                sys.path.remove(p)
            raise missing from e
        self._cosyvoice = CosyVoice(model_dir)

    def convert(self, source_path: str, reference_path: str, output_path: str) -> str:
        def at_16k(path):
            wave, sr = load_wav(path)
            return resample(torch.from_numpy(wave), sr, 16000)[None]

        out = None
        for piece in self._cosyvoice.inference_vc(at_16k(source_path), at_16k(reference_path),
                                                  stream=False):
            out = piece["tts_speech"]
        save_wav(output_path, np.asarray(out.cpu().numpy()).ravel(), 22050)
        return output_path


class CommandBaseline:
    """External converter through a command template, e.g.
    ``CommandBaseline("python vc.py --src {source} --ref {reference} --out
    {output}")``."""

    def __init__(self, template: str, timeout_s: float = 600.0):
        for field in ("{source}", "{reference}", "{output}"):
            if field not in template:
                raise ValueError(f"command template must contain {field}")
        self.template = template
        self.timeout_s = timeout_s

    def convert(self, source_path: str, reference_path: str, output_path: str) -> str:
        cmd = self.template.format(source=shlex.quote(source_path),
                                   reference=shlex.quote(reference_path),
                                   output=shlex.quote(output_path))
        subprocess.run(cmd, shell=True, check=True, timeout=self.timeout_s)
        return output_path


def get_baseline(name: str, **kwargs):
    """``openvoice`` (``checkpoint_pkl``, ``tau``, ``device``), ``cosyvoice``
    (``repo_dir``, ``model_dir``) or ``command`` (``template``,
    ``timeout_s``)."""
    if name == "openvoice":
        return OpenVoiceBaseline(kwargs["checkpoint_pkl"], tau=kwargs.get("tau", 0.3),
                                 device=kwargs.get("device", "cuda"))
    if name == "cosyvoice":
        if not kwargs.get("repo_dir"):
            raise ValueError("the cosyvoice baseline needs repo_dir (--cosyvoice-dir)")
        return CosyVoiceBaseline(
            kwargs["repo_dir"],
            model_dir=kwargs.get("model_dir") or "pretrained_models/CosyVoice-300M-25Hz")
    if name == "command":
        return CommandBaseline(kwargs["template"], timeout_s=kwargs.get("timeout_s", 600.0))
    raise KeyError(f"unknown baseline {name!r}; known: openvoice, cosyvoice, command")
