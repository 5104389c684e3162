"""Port DSP front-ends against the JAX package at fp32.

Tolerances: mel and whisper mel are logs of fp32 spectra computed with a
matmul DFT (JAX) vs an FFT (port), so they agree to ~1e-5; the kaldi fbank
takes the log of raw power in bins that can be tiny, where the two DFTs'
fp32 rounding shows at ~1e-4 -> atol 1e-3.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.core.config import SpectConfig as JSpectConfig
from seedvc_tpu.dsp.fbank import kaldi_fbank as j_fbank
from seedvc_tpu.dsp.mel import MelFrontend as JMelFrontend
from seedvc_tpu.dsp.mel import mel_filterbank as j_mel_filterbank
from seedvc_tpu.dsp.resample import resample_host as j_resample_host
from seedvc_tpu.dsp.whisper_mel import whisper_log_mel as j_whisper_log_mel
from seedvc_tpu.pipelines.convert import VoiceConverter as JVoiceConverter
from seedvc_tpu_torch.core.config import SpectConfig, get_preset
from seedvc_tpu_torch.dsp.fbank import kaldi_fbank
from seedvc_tpu_torch.dsp.filters import kaiser_sinc_filter1d
from seedvc_tpu_torch.dsp.mel import MelFrontend, mel_filterbank
from seedvc_tpu_torch.dsp.resample import resample_host
from seedvc_tpu_torch.dsp.whisper_mel import whisper_log_mel
from seedvc_tpu_torch.pipelines.convert import VoiceConverter

torch.set_num_threads(1)


def _wave(n, seed=0, sr=22050):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_filters_match_jax():
    from seedvc_tpu.dsp.filters import kaiser_sinc_filter1d as j_filter

    np.testing.assert_array_equal(kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  j_filter(0.25, 0.3, 12))


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, None), (16000, 400, 80, 0.0, 8000.0),
                                  (44100, 2048, 128, 0.0, None)])
def test_mel_filterbank_matches_jax(args):
    np.testing.assert_array_equal(mel_filterbank(*args), j_mel_filterbank(*args))


def test_mel_frontend_matches_jax():
    w = _wave(22050 + 77)[None]
    ref = np.asarray(JMelFrontend(22050, JSpectConfig())(jnp.asarray(w)))
    out = MelFrontend(22050, SpectConfig())(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("n", [3 * 22050 + 131, 5 * 22050])
def test_mel_bucketed_reflect_tail_matches_jax(n):
    """The 5 s bucket with its reflect-continued tail (PARITY.md:228-229),
    through both pipelines' ``_mel_bucketed`` on the same wave."""
    w = _wave(n, seed=1)
    cfg = get_preset("whisper_small_wavenet")
    fake = SimpleNamespace(sr=22050, hop=256, cfg=cfg,
                           mel_fn=lambda y: JMelFrontend(22050, JSpectConfig())(y))
    ref = np.asarray(JVoiceConverter._mel_bucketed(fake, w))
    port_self = SimpleNamespace(sr=22050, hop=256, cfg=cfg, device=torch.device("cpu"),
                                mel_fn=MelFrontend(22050, SpectConfig()))
    out = VoiceConverter._mel_bucketed(port_self, w).numpy()
    assert out.shape == ref.shape == (1, n // 256, 80)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_whisper_log_mel_matches_jax():
    w = _wave(16000 * 2 + 33, seed=2, sr=16000)[None]
    ref = np.asarray(j_whisper_log_mel(jnp.asarray(w)))
    out = whisper_log_mel(torch.from_numpy(w)).numpy()
    assert out.shape == (1, 3000, 80)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_kaldi_fbank_matches_jax():
    w = _wave(16000 + 555, seed=3, sr=16000)[None]
    ref = np.asarray(j_fbank(jnp.asarray(w)))
    out = kaldi_fbank(torch.from_numpy(w)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3)


@pytest.mark.parametrize("rates", [(22050, 16000), (44100, 22050), (16000, 16000)])
def test_resample_host_matches_jax(rates):
    w = _wave(12345, seed=4)
    np.testing.assert_array_equal(resample_host(w, *rates), j_resample_host(w, *rates))
