"""The AR decode step's kernel chain (seedvc_tpu_torch/ops/ar_decode.py) on
the CPU, where only the plain twins run.

The chain of twins, driven by ``ARTransformer.decode_chain``, computes the
plain decode step (``decode_step_reference``): the same logits within f32
rounding and the same cache slots written, for one and several rows, at a
mid-cache slot and past the cache's end (the clamp), with and without
per-row ``min_key``; the attention twin reads no slot outside a row's valid
range. On the CPU ``decode_step`` is the plain step and launches no kernel.
Each wrapper raises on a CPU tensor, a wrong type, shape or layout before it
launches anything, and counts its own kernel's launches. The kernels
themselves are held to these twins on the card (tests/test_torch_cuda.py).
"""

import contextlib
import dataclasses
import types

import pytest
import torch

from seedvc_tpu_torch.core.profiling import StageTimer
from seedvc_tpu_torch.models.ar import ARConfig, ARGenerator, ARTransformer
from seedvc_tpu_torch.ops import ar_decode

torch.set_num_threads(1)

CFG = ARConfig(dim=96, n_layer=2, n_head=6, n_local_heads=2, head_dim=16,
               intermediate_size=160, vocab_size=41, max_seq_len=48)
TWINS = ("attn_in", "attention", "attn_out", "ffn_in", "ffn_out", "head")


def _model(seed=0, cfg=CFG):
    torch.manual_seed(seed)
    model = ARTransformer(cfg).eval()
    with torch.no_grad():  # RMSNorm weights away from 1, so a norm left out shows
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.uniform_(0.5, 1.5)
    return model


def _filled_caches(model, B, seed):
    """Caches with every slot drawn, as a prefill and earlier steps leave them."""
    g = torch.Generator().manual_seed(seed)
    kc, vc = model.new_caches(B, "cpu", torch.float32)
    kc.normal_(generator=g)
    vc.normal_(generator=g)
    return kc, vc


@pytest.fixture
def twins(monkeypatch):
    """The chain's kernels replaced by their plain twins."""
    for name in TWINS:
        monkeypatch.setattr(ar_decode, name, getattr(ar_decode, f"{name}_reference"))


@pytest.mark.parametrize("B,kv_pos,min_key", [(1, 20, None), (3, 30, (0, 5, 29)),
                                              (3, 47, (2, 40, 47)), (2, 60, (0, 13))],
                         ids=["one_row", "mid_cache", "last_slot", "past_the_end"])
def test_twin_chain_is_the_plain_step(twins, B, kv_pos, min_key):
    model = _model()
    kc, vc = _filled_caches(model, B, seed=1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((B, 1, CFG.dim), generator=g)
    input_pos = torch.randint(0, 70, (B,), generator=g)
    kv = torch.tensor(kv_pos)
    mk = None if min_key is None else torch.tensor(min_key)
    ref_kc, ref_vc = kc.clone(), vc.clone()
    before = kc.clone(), vc.clone()
    with torch.no_grad():
        ref = model.decode_step_reference(x, input_pos, kv, ref_kc, ref_vc, mk)
        got = model.decode_chain(x, input_pos, kv, kc, vc, mk,
                                 ar_decode.new_scratch(B, CFG, "cpu", torch.float32))
    assert got.dtype == torch.float32 and got.shape == (B, CFG.vocab_size)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(kc, ref_kc, atol=2e-5, rtol=0)
    torch.testing.assert_close(vc, ref_vc, atol=2e-5, rtol=0)
    keep = torch.arange(CFG.max_seq_len) != min(kv_pos, CFG.max_seq_len - 1)
    for c, old in zip((kc, vc), before):  # every other slot as it was
        assert torch.equal(c[:, :, :, keep], old[:, :, :, keep])


def test_attention_twin_reads_only_valid_slots():
    """NaN in every slot outside [min_key[b], kv_pos] leaves the output as
    it was."""
    B, H, G, S, hd = 3, 6, 2, 48, 16
    g = torch.Generator().manual_seed(3)
    q = torch.randn((B, H, hd), generator=g)
    kc, vc = (torch.randn((B, G, S, hd), generator=g) for _ in range(2))
    kv, mk = torch.tensor(30), torch.tensor([0, 7, 30])
    clean = torch.empty(B, H * hd)
    ar_decode.attention_reference(q, kc, vc, kv, mk, clean)
    keys = torch.arange(S)
    outside = (keys[None, :] > kv) | (keys[None, :] < mk[:, None])  # (B, S)
    kc[outside[:, None, :, None].expand_as(kc)] = float("nan")
    vc[outside[:, None, :, None].expand_as(vc)] = float("nan")
    poisoned = torch.empty(B, H * hd)
    ar_decode.attention_reference(q, kc, vc, kv, mk, poisoned)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


def test_decode_step_on_the_cpu_is_the_plain_step():
    model = _model()
    B = 2
    kc, vc = _filled_caches(model, B, seed=4)
    x = torch.randn((B, 1, CFG.dim))
    args = (torch.tensor([3, 9]), torch.tensor(12))
    with torch.no_grad():
        a = model.decode_step(x, *args, kc.clone(), vc.clone(), torch.tensor([0, 4]))
        b = model.decode_step_reference(x, *args, kc.clone(), vc.clone(), torch.tensor([0, 4]))
    assert torch.equal(a, b)


def test_generate_on_the_cpu_launches_no_kernel():
    cfg = dataclasses.replace(CFG, max_seq_len=128)
    model = _model(cfg=cfg)
    launches = ar_decode.LAUNCHES
    gen = ARGenerator(model, 12, device="cpu")
    timer = StageTimer(record=True)
    g = torch.Generator().manual_seed(5)
    gen.generate(torch.randn((2, 7, cfg.dim), generator=g), torch.tensor([7, 4]),
                 torch.randint(0, 40, (2, 5), generator=g), torch.tensor([5, 2]), seed=1,
                 timer=timer)
    dec = timer.report()["ar.decode"]
    assert ar_decode.LAUNCHES == launches and gen.fused_launches is None
    assert dec["steps"] == gen.decode_steps > 0 and "fused_steps" not in dec


def test_decode_chain_refuses_a_tensor_parallel_model():
    model = _model()
    model.layers_1.attention.tp_group = object()
    kc, vc = _filled_caches(model, 1, seed=6)
    with pytest.raises(RuntimeError, match="tensor-parallel"):
        model.decode_chain(torch.zeros(1, 1, CFG.dim), torch.tensor([0]), torch.tensor(0), kc, vc,
                           None, ar_decode.new_scratch(1, CFG, "cpu", torch.float32))


def test_new_scratch_shapes():
    s = ar_decode.new_scratch(3, ARConfig(), "cpu", torch.bfloat16)
    assert s.q.shape == (3, 12, 64) and s.attn.shape == (3, 768) and s.x.shape == (3, 768)
    assert s.hidden.shape == (3, 2304) and s.hidden.dtype == torch.bfloat16
    assert s.part.shape == (3, 2, ar_decode.MAX_RUNS, ar_decode.RECORD)
    assert s.counters.dtype == torch.int32 and not s.counters.any()
    assert s.logits.shape == (3, 2049) and s.logits.dtype == torch.float32


# --- the wrappers' checks ---------------------------------------------------

def _args(kernel, dtype=torch.float32, B=2):
    """Well-formed CPU arguments of one wrapper at ARConfig()'s widths (a
    short cache), as (positional args, keyword args)."""
    c = ARConfig(max_seq_len=32)
    D, H, G, S, hd, I, V = (c.dim, c.n_head, c.n_local_heads, c.max_seq_len, c.head_dim,
                            c.intermediate_size, c.vocab_size)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt)
    pos, kv = torch.zeros(B, dtype=torch.int64), torch.tensor(5)
    if kernel == "attn_in":
        return (z(B, D), z(D), z((H + 2 * G) * hd, D), z(S, hd // 2, 2, dt=torch.float32), pos,
                kv, z(B, H, hd), z(B, G, S, hd), z(B, G, S, hd)), {"eps": 1e-5}
    if kernel == "attention":
        return (z(B, H, hd), z(B, G, S, hd), z(B, G, S, hd), kv, pos, z(B, H * hd),
                z(B, G, ar_decode.MAX_RUNS, ar_decode.RECORD, dt=torch.float32),
                z(B, G, dt=torch.int32)), {}
    if kernel == "attn_out":
        return (z(B, H * hd), z(D, H * hd), z(B, D), z(B, D)), {}
    if kernel == "ffn_in":
        return (z(B, D), z(D), z(I, D), z(I, D), z(B, I)), {"eps": 1e-5}
    if kernel == "ffn_out":
        return (z(B, I), z(D, I), z(B, D)), {}
    return (z(B, D), z(D), z(V, D), z(B, V, dt=torch.float32)), {"eps": 1e-5}


def _fault(args, fault):
    args = list(args)
    if fault == "dtype":  # the first tensor in half precision
        args[0] = args[0].half()
    elif fault == "mixed":  # a later tensor in another type than the first
        args[1] = args[1].bfloat16()
    elif fault == "shape":
        args[1] = args[1][..., :-1].contiguous()
    elif fault == "layout":  # a weight or cache of the right shape, not contiguous
        i = next(i for i, a in enumerate(args) if i and a.dim() >= 2)
        args[i] = args[i].transpose(-1, -2).contiguous().transpose(-1, -2)
    return args


@pytest.mark.parametrize("kernel", TWINS)
@pytest.mark.parametrize("fault", ["device", "dtype", "mixed", "shape", "layout"])
def test_wrappers_raise_before_launching(kernel, fault):
    args, kw = _args(kernel)
    args = _fault(args, fault) if fault != "device" else list(args)
    launches = ar_decode.LAUNCHES
    match = {"device": "CUDA tensors only", "dtype": "bf16 or f32", "mixed": "needs",
             "shape": "shape", "layout": "contiguous"}[fault]
    with pytest.raises(ValueError, match=match):
        getattr(ar_decode, kernel)(*args, **kw)
    assert ar_decode.LAUNCHES == launches


@pytest.mark.parametrize("kernel", TWINS)
def test_twins_take_the_wrappers_arguments(kernel):
    """Each twin runs on the arguments its wrapper refuses on the CPU."""
    args, kw = _args(kernel)
    getattr(ar_decode, f"{kernel}_reference")(*args, **kw)


def test_wrappers_check_the_group_and_the_head_size():
    """Shapes consistent among themselves that the kernels do not take: 9
    or 8 query heads over 2 KV heads (the kernel takes 6 a KV head), a head
    size of 32."""
    B, S = 2, 32
    part = torch.zeros(B, 2, ar_decode.MAX_RUNS, ar_decode.RECORD)
    counters = torch.zeros(B, 2, dtype=torch.int32)
    kv, pos = torch.tensor(5), torch.zeros(B, dtype=torch.int64)
    for H in (9, 8):
        with pytest.raises(ValueError, match=f"{H} query heads over 2"):
            ar_decode.attention(torch.zeros(B, H, 64), torch.zeros(B, 2, S, 64),
                                torch.zeros(B, 2, S, 64), kv, pos, torch.zeros(B, H * 64), part,
                                counters)
    with pytest.raises(ValueError, match="head size 32"):
        ar_decode.attention(torch.zeros(B, 12, 32), torch.zeros(B, 2, S, 32),
                            torch.zeros(B, 2, S, 32), kv, pos, torch.zeros(B, 12 * 32), part,
                            counters)
    with pytest.raises(ValueError, match="head size 32"):
        ar_decode.attn_in(torch.zeros(B, 96), torch.zeros(96), torch.zeros(16 * 32, 96),
                          torch.zeros(S, 16, 2), pos, kv, torch.zeros(B, 12, 32),
                          torch.zeros(B, 2, S, 32), torch.zeros(B, 2, S, 32), 1e-5)


def test_each_wrapper_counts_its_own_kernel(monkeypatch):
    """The chain through the wrappers, their C entry points stubbed: one
    launch of each layer kernel a layer and of the head, counted in
    ``KERNEL_LAUNCHES`` and summed in ``LAUNCHES``; ``reset_counts`` zeroes
    both; an entry point's error raises and counts nothing."""
    cfg = ARConfig(dim=64, n_layer=2, n_head=12, n_local_heads=2, head_dim=64,
                   intermediate_size=96, vocab_size=33, max_seq_len=64)
    model = _model(cfg=cfg)
    entries, code = [], [0]

    def stub(entry):
        return lambda *a: entries.append(entry) or code[0]
    monkeypatch.setattr(ar_decode, "_ENTRIES", {e: stub(e) for e in ar_decode._SIGNATURES})
    monkeypatch.setattr(ar_decode, "_on_card", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(ar_decode, "KERNEL_LAUNCHES", dict.fromkeys(ar_decode.KERNELS, 7))
    monkeypatch.setattr(ar_decode, "LAUNCHES", 42)
    ar_decode.reset_counts()
    assert ar_decode.LAUNCHES == 0 and not any(ar_decode.KERNEL_LAUNCHES.values())
    kc, vc = model.new_caches(1, "cpu", torch.float32)
    args = (torch.zeros(1, 1, cfg.dim), torch.tensor([3]), torch.tensor(3), kc, vc, None,
            ar_decode.new_scratch(1, cfg, "cpu", torch.float32))
    with torch.no_grad():
        model.decode_chain(*args)
    layer = ["ar_attn_in", "ar_attention", "ar_residual", "ar_ffn_in", "ar_residual"]
    assert entries == layer * cfg.n_layer + ["ar_head"]
    assert ar_decode.KERNEL_LAUNCHES == {k: 1 if k == "head" else cfg.n_layer
                                         for k in ar_decode.KERNELS}
    assert ar_decode.LAUNCHES == 5 * cfg.n_layer + 1
    code[0] = 700
    with torch.no_grad(), pytest.raises(RuntimeError, match="error 700"):
        model.decode_chain(*args)
    assert ar_decode.LAUNCHES == 5 * cfg.n_layer + 1
