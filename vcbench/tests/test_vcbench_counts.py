"""The operation and byte counters against hand counts at tiny shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vcbench import peaks, v1
from vcbench.builders import voice_converter as B
from vcbench.readers import k2_shapes

from conftest import FIXTURES, REPO


def tiny():
    return json.loads((FIXTURES / "tiny_v1.json").read_text())


def test_k1_bound_by_hand():
    # (2, 8, 2048, 64), 1966 valid keys a row: PERF.md's kernel table reads 0.0167 ms
    ops = 4 * 64 * 2048 * 8 * (2 * 1966)
    nbytes = 2 * (2048 + 2048) * 2 * 8 * 64 * 2 + 2 * 2048 * 64 * 4 + 2 * 4
    assert peaks.k1_bf16(2, 8, 2048, 2048, 2 * 1966) == max(ops / 989e12, nbytes / 3.35e12)
    assert peaks.k1_bf16(2, 8, 2048, 2048, 2 * 1966) * 1e3 == pytest.approx(0.0167, abs=5e-5)


def test_k2_bound_by_hand():
    # (1, 24, 393216): bytes-bound, 8 bytes an element
    n = 24 * 393216
    assert peaks.k2(1, 24, 393216) == max(98 * n / 67e12, (8 * n + 8 * 24) / 3.35e12)
    assert peaks.k2(1, 24, 393216) * 1e3 == pytest.approx(0.0225, abs=5e-5)


def test_k2_shapes_of_bigvgan_22k():
    cfg = json.loads((REPO / "vcbench" / "configs" / "whisper_small_wavenet.json").read_text())
    shapes = k2_shapes(cfg, 1536)
    assert len(shapes) == 109  # 218 launches for phase 5's two chunks
    assert shapes[0] == (1, 768, 1536 * 4) and shapes[-1] == (1, 24, 1536 * 256)


def test_meta_counts_equal_counts_on_real_tensors():
    cfg = tiny()
    c = B.Counter(cfg)
    with torch.device("cpu"):
        ref_cfg, enc, voc = B.configs("vcbench.ref", cfg)
        from vcbench.ref.models.bigvgan import BigVGAN
        from vcbench.ref.models.whisper import WhisperEncoder
        w, g = WhisperEncoder(enc), BigVGAN(voc)
    with FlopCounterMode(display=False) as m:
        w(torch.zeros(1, 3000, 80))
    assert c.whisper_window() == m.get_total_flops()
    with FlopCounterMode(display=False) as m:
        g(torch.zeros(1, 16, 80))
    assert c.vocode(16) == m.get_total_flops()


def test_whisper_window_by_hand():
    cfg = tiny()
    e = cfg["content_encoder"]
    d, f, L, T = e["d_model"], e["ffn_dim"], e["n_layers"], 1500
    conv = 2 * 3 * 80 * d * 3000 + 2 * 3 * d * d * 1500
    layer = T * (2 * 4 * d * d + 2 * 2 * d * f) + 2 * 2 * T * T * d
    assert B.Counter(cfg).whisper_window() == conv + L * layer


def test_attention_is_counted_by_valid_keys():
    cfg = tiny()
    c = B.Counter(cfg)
    dense5, attn5 = c.sampler(192, 5, 100)
    dense1, attn1 = c.sampler(192, 1, 100)
    mp = cfg["preset"]["model_params"]["DiT"]
    per_step = mp["depth"] * 4 * (mp["hidden_dim"] // mp["num_heads"]) * 192 \
        * mp["num_heads"] * 2 * 100
    assert attn5 == 5 * per_step and attn1 == per_step
    assert dense5 > dense1 > 0


def test_conversion_ops_split_by_precision():
    cfg, tr = tiny(), json.loads((FIXTURES / "tiny_offline.json").read_text())
    inputs = v1.make_inputs(tr, 1)
    from vcbench import traffic as T
    s = T.cycle(tr)[-1]
    req = T.Request(0, s["slot"], 0, 0, 3)
    L = v1.lengths(cfg, tr, req, inputs[s["slot"]])
    ops = v1.conversion_ops(B.Counter(cfg), cfg, L, 3)
    assert ops["low"] > 0 and ops["f32"] > 0 and ops["chunks"] >= 1
