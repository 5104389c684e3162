"""The port's microbench entry point (seedvc_tpu_torch/apps/microbench.py),
every ported component at tiny sizes on the CPU: each prints one JSON row
with the JAX package's keys, and the attention components take the branch
they name; the training components train through the K1 Function. Times here
are CPU times and are not read."""

import dataclasses
import json

import pytest
import torch

from seedvc_tpu_torch.apps import microbench as mb
from seedvc_tpu_torch.core import config as c
from seedvc_tpu_torch.models.ar import ARConfig
from seedvc_tpu_torch.models.astral import AstralConfig
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
from seedvc_tpu_torch.models.ssl import SSLConfig
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.nn import layers
from seedvc_tpu_torch.ops import attention
from seedvc_tpu_torch.pipelines.convert_v2 import V2Config

torch.set_num_threads(1)


def _tiny_cfg():
    cfg = c.get_preset("whisper_small_wavenet")
    mp = cfg.model_params
    return dataclasses.replace(cfg, model_params=dataclasses.replace(
        mp, DiT=dataclasses.replace(mp.DiT, hidden_dim=128, num_heads=2, depth=2,
                                    content_dim=64),
        wavenet=dataclasses.replace(mp.wavenet, hidden_dim=32, num_layers=2)))


def _tiny_train_cfg():
    """The tiny DiT with a 64-wide regulator, fed by a 64-wide Whisper."""
    cfg = _tiny_cfg()
    mp = cfg.model_params
    return dataclasses.replace(cfg, model_params=dataclasses.replace(
        mp, length_regulator=dataclasses.replace(mp.length_regulator, in_channels=64,
                                                 channels=64)))


TINY_WHISPER = WhisperEncoderConfig(d_model=64, n_layers=1, n_heads=4, ffn_dim=128)
TINY_AR = ARConfig(dim=32, n_layer=2, n_head=4, n_local_heads=2, head_dim=8,
                   intermediate_size=64, vocab_size=33)
TINY_V2 = V2Config(
    dit=DiTV2Config(hidden_dim=32, depth=2, num_heads=4, content_dim=32, style_encoder_dim=24),
    ar=ARConfig(dim=32, n_layer=2, n_head=4, n_local_heads=2, head_dim=8, intermediate_size=64,
                vocab_size=33, max_seq_len=1024),
    ssl=SSLConfig(conv_dim=16, d_model=32, n_layers=1, n_heads=4, ffn_dim=64),
    narrow=AstralConfig(dim=24, intermediate_dim=48, num_blocks=1, input_dim=32,
                        codebook_size=8),
    wide=AstralConfig(dim=24, intermediate_dim=48, num_blocks=1, input_dim=32,
                      codebook_size=32))
TINY_VOC = BigVGANConfig(upsample_initial_channel=128, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1,),))

# component -> (tiny arguments, the rate key the JAX row carries)
CASES = {
    "attention": (dict(B=1, T=512, H=2, hd=64), "tflops_per_s"),
    "attention_xla": (dict(B=1, T=512, H=2, hd=64), "tflops_per_s"),
    "ffn": (dict(B=1, T=32, d=64), "tflops_per_s"),
    "int8_matmul": (dict(M=32, K=64, N=32), "tflops_per_s"),
    "wavenet": (dict(B=1, T=32, cfg=_tiny_cfg()), "tflops_per_s"),
    "dit": (dict(B=1, T=512, cfg=_tiny_cfg()), "tflops_per_s"),
    "vocoder": (dict(B=1, T=4, cfg=TINY_VOC), "audio_s_per_s"),
    "serving": (dict(B=2, T=512, n_steps=2, cfg=_tiny_cfg()), "audio_s_per_s"),
    "serving_b1": (dict(T=512, n_steps=2, cfg=_tiny_cfg()), "audio_s_per_s"),
    "serving_b2": (dict(T=512, n_steps=2, cfg=_tiny_cfg()), "audio_s_per_s"),
    "ar_decode": (dict(n_tokens=4, max_seq=64, cfg=TINY_AR), "tokens_per_s"),
    "ar_decode_b4": (dict(n_tokens=4, max_seq=64, cfg=TINY_AR), "tokens_per_s"),
    "train_step": (dict(B=1, T=64, Ts=32, cfg=_tiny_train_cfg()), "steps_per_s"),
    "train_step_bf16": (dict(B=1, T=64, Ts=32, cfg=_tiny_train_cfg()), "steps_per_s"),
    "train_onfly": (dict(B=1, steps=1, cfg=_tiny_train_cfg(), whisper_cfg=TINY_WHISPER),
                    "steps_per_s"),
    "train_onfly_sync": (dict(B=1, steps=1, cfg=_tiny_train_cfg(), whisper_cfg=TINY_WHISPER),
                         "steps_per_s"),
    "train_onfly_v2": (dict(B=1, steps=2, cfg=TINY_V2), "steps_per_s"),
}


def test_every_ported_component_has_a_case():
    assert set(CASES) == set(mb.ALL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_component_prints_jax_row(name, capsys):
    kwargs, rate = CASES[name]
    out = mb.ALL[name](device="cpu", **kwargs)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows == (out if isinstance(out, list) else [out])
    for row in rows:
        assert row["ms_per_token" if name.startswith("ar_") else "ms"] > 0 and row[rate] > 0
        assert row["device"] == "cpu" and row["calls"] >= 2
    if name == "int8_matmul":
        assert [r["name"].split()[0] for r in rows] == ["matmul2_bf16", "matmul2_int8_dynamic"]


@pytest.mark.parametrize("name,expect", [("attention", "k3"), ("attention_xla", None),
                                         ("dit", "k1")])
def test_component_takes_its_attention_branch(monkeypatch, name, expect):
    calls = []
    monkeypatch.setattr(layers, "dit_attention_fused",
                        lambda *a: calls.append("k1") or attention.dit_attention_fused(*a))
    monkeypatch.setattr(layers, "dit_attention",
                        lambda *a: calls.append("k3") or attention.dit_attention(*a))
    kwargs, _ = CASES[name]
    row = mb.ALL[name](device="cpu", **kwargs)
    per_call = _tiny_cfg().model_params.DiT.depth if name == "dit" else 1
    assert calls == ([expect] * per_call * row["calls"] if expect else [])


@pytest.mark.parametrize("name", ["train_onfly_v2"])
def test_waiting_components_raise(name, capsys):
    """The v2 trainer's component, which waited for ROADMAP queue 1 item 3b,
    is ported: it is in ``ALL`` and runs tiny on the CPU from one trainer,
    a row for the prefetch window and one for the synchronous one, whose
    calls add up to the steps run (3 warm + 2 x steps)."""
    assert name in mb.ALL
    kwargs, rate = CASES[name]
    rows = mb.ALL[name](device="cpu", **kwargs)
    assert rows == [json.loads(line) for line in capsys.readouterr().out.splitlines()
                    if line.startswith("{")]
    assert [r["name"].split()[0] for r in rows] == ["train_onfly_v2_prefetch",
                                                    "train_onfly_v2_sync"]
    assert sum(r["calls"] for r in rows) == 3 + 2 * kwargs["steps"]
    assert all(r[rate] > 0 for r in rows)


@pytest.mark.parametrize("B", [1, 4])
def test_ar_decode_feeds_back_the_argmax(monkeypatch, B):
    """Each step decodes the previous step's argmax at the next position, as
    the JAX component's loop does."""
    from seedvc_tpu_torch.models import ar

    seen = []
    real = ar.ARTransformer.decode_step

    def spy(self, x_emb, input_pos, kv_pos, *a, **kw):
        seen.append((int(kv_pos), input_pos.tolist()))
        return real(self, x_emb, input_pos, kv_pos, *a, **kw)

    monkeypatch.setattr(ar.ARTransformer, "decode_step", spy)
    row = mb.ALL["ar_decode" if B == 1 else "ar_decode_b4"](device="cpu", n_tokens=3,
                                                           max_seq=16, cfg=TINY_AR)
    assert row["name"].startswith(f"ar_decode B{B} seq16") and not row["graph"]
    assert seen[:3] == [(i, [i] * B) for i in range(3)] and len(seen) == row["calls"]


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.main(["--only", "ffn"])
    with pytest.raises(SystemExit):
        mb.main(["--only", "no_such_component"])
