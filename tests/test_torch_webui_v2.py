"""v2 through the port's web UI and the JAX package's, on the CPU at tiny
sizes: tests/test_torch_v2_pipeline.py's converters (the same flax trees on
both sides) in each server's cache under ``v2:v2``, ``convert_style=0`` (no
AR), the same position-indexed CFM noise on both (JAX by patching
``jax.random.normal`` for the request, the port by binding its
``convert_voice_with_streaming`` to ``noise_fn``); a 150-frame source, so
two chunks.

Limit on the int16 bodies: 34 LSB, the pipeline tests' 1e-3 on the wave
times 32767, plus one for the truncation to int16. The port's chunked wav
stream must carry its own ``/api/convert`` body's PCM exactly, and its
``X-Stats`` (with the plan and the AR entries) must be JSON.
"""

import functools

import pytest
import torch

import seedvc_tpu.pipelines.convert_v2 as jconv_v2
import seedvc_tpu_torch.pipelines.convert_v2 as pconv_v2
import test_torch_pipeline as v1t
import test_torch_v2_pipeline as v2t
from seedvc_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from test_torch_webui_convert import _wav, check_convert, serve_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def servers():
    jcfg = v2t.tiny_v2()
    params = v2t._jax_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv_v2, "BIGVGAN_22K_80", JBigVGANConfig(**v1t.VOC))
        mp.setattr(pconv_v2, "BIGVGAN_22K_80", BigVGANConfig(**v1t.VOC))
        jvc = jconv_v2.VoiceConverterV2(jcfg, params=params)
        pvc = pconv_v2.VoiceConverterV2(v2t._port_cfg(jcfg), params=params, device="cpu")
    pvc.convert_voice_with_streaming = functools.partial(
        pconv_v2.VoiceConverterV2.convert_voice_with_streaming, pvc, noise_fn=v2t._port_noise)
    yield from serve_pair("v2:v2", jvc, pvc)


def test_v2_timbre_matches_jax_server(servers, monkeypatch):
    fields = {"mode": "v2", "convert_style": "0", "diffusion_steps": v2t.STEPS,
              "intelligibility_cfg_rate": 0.3, "similarity_cfg_rate": 0.9,
              "source": ("s.wav", _wav(v2t._audio(150, 150.0, 7))),
              "target": ("r.wav", _wav(v2t._audio(40, 220.0, 8)))}
    stats = check_convert(servers, monkeypatch, fields, v2t.NOISE, "wav")
    assert stats["ar_batch"] == 0 and stats["decode_steps"] == 0
    assert len(stats["plan"]) == 3 and stats["target_len"] == 150
