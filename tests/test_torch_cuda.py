"""The port's CUDA kernels on the card (every test here is marked ``cuda``
and skips without a CUDA device).

This file imports nothing of JAX, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Each kernel is held to its plain PyTorch twin on the same CUDA inputs.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.nn.layers import rope_full_cache
from seedvc_tpu_torch.ops import anti_alias, attention

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).cuda()


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("T,lens", [(777, (700, 300)), (2048, None), (64, (1, 64)),
                                    (2560, None), (777, (0, 1)), (2048, (1966, 1477))])
@pytest.mark.parametrize("dtype,tol,rel_tol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 1e-2, 2e-2)])
def test_attention_kernel_matches_twin(T, lens, dtype, tol, rel_tol, rope):
    """K1 (RoPE in the call) and K3 (q/k already roped), one source. The
    cases hold K3's shape (T = 2560, every key valid), lens with a 0 entry
    (every key masked: the mean of V) and a 1 entry, and the main path's lens
    (1966, 1477), where the bf16 core skips fully masked key tiles.
    f32: summation order only -> 1e-4. bf16: P and the output round to
    bf16 after a running rather than a global max; measured up to 4e-3 on an
    output whose std is about sqrt(e/T) (0.036 at T = 2048) -> 1e-2, and a
    relative L2 norm of 2e-2, which dropping one 64-key tile exceeds."""
    q, k, v = (_randn(s, 2, 8, T, 64).to(dtype) for s in range(3))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    if rope:
        cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
        before = attention.LAUNCHES
        out = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
        assert attention.LAUNCHES == before + 1
        ref = attention.dit_attention_fused_reference(q, k, v, cos, sin, lens_t)
    else:
        before = attention.DIT_ATTENTION_LAUNCHES
        out = attention.dit_attention(q, k, v, lens_t)
        assert attention.DIT_ATTENTION_LAUNCHES == before + 1
        ref = attention.dit_attention_reference(q, k, v, lens_t)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    rel = (out.float() - ref.float()).norm() / ref.float().norm()
    assert rel <= rel_tol


@pytest.mark.parametrize("lens", [(1966, 1493), (0, 1966)])
@pytest.mark.parametrize("dtype,tol,rel_tol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 1e-2, 2e-2)])
def test_attention_kernel_at_svc_heads(lens, dtype, tol, rel_tol):
    """K1 at the SVC path's shape: 12 heads (the 768-wide DiT of
    whisper_base_f0_44k), T = 2048, its chunks' lens and a 0 entry; the
    limits of test_attention_kernel_matches_twin."""
    q, k, v = (_randn(s + 20, 2, 12, 2048, 64).to(dtype) for s in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(2048, 64))
    out = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
    ref = attention.dit_attention_fused_reference(q, k, v, cos, sin, lens_t)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert (out.float() - ref.float()).norm() / ref.float().norm() <= rel_tol


@pytest.mark.parametrize("T,lens", [(331, None), (2050, (1968, 1968)), (2050, (1495, 1495)),
                                    (2050, (0, 1968))])
@pytest.mark.parametrize("dtype,tol,rel_tol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 1e-2, 2e-2)])
def test_attention_kernel_at_realtime_shapes(T, lens, dtype, tol, rel_tol):
    """K1 at xlsr_tiny's 6 heads with its 2 prefix tokens: a streaming
    block's T = 331 (every key valid) and the offline chunks' T = 2050 (no
    multiple of 64) with their lens and a 0 entry; the limits of
    test_attention_kernel_matches_twin."""
    q, k, v = (_randn(s + 40, 2, 6, T, 64).to(dtype) for s in range(3))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
    out = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
    ref = attention.dit_attention_fused_reference(q, k, v, cos, sin, lens_t)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert (out.float() - ref.float()).norm() / ref.float().norm() <= rel_tol


@pytest.mark.parametrize("T,lens", [(2560, (2154, 2154, 2154)), (2048, (1966, 1497, 0)),
                                    (2048, (1497, 1497, 1497))])
@pytest.mark.parametrize("dtype,tol,rel_tol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 1e-2, 2e-2)])
def test_attention_kernel_at_v2_shapes(T, lens, dtype, tol, rel_tol):
    """K1 at the v2 DiT's shapes: the 3-way CFG stack (B = 3), 8 heads, T
    with the 2 prefix tokens; a 20 s source with a 5 s reference is one
    chunk at T = 2560 with 2154 valid keys, a 30 s source two chunks at T =
    2048 (1966 and 1497 keys); a 0 entry. The limits of
    test_attention_kernel_matches_twin."""
    q, k, v = (_randn(s + 80, 3, 8, T, 64).to(dtype) for s in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
    out = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
    ref = attention.dit_attention_fused_reference(q, k, v, cos, sin, lens_t)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert (out.float() - ref.float()).norm() / ref.float().norm() <= rel_tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ar_decode_graph_replay_matches_eager(dtype):
    """The v2 AR decode (ARConfig() cut to 4 layers), two left-padded rows,
    48 new tokens from the same draws: the decode step replayed from one
    CUDA graph emits the tokens and counts of the same step run eagerly;
    the replays run none of the kernel wrappers."""
    from seedvc_tpu_torch.models.ar import ARConfig, ARGenerator, ARTransformer

    torch.manual_seed(0)
    model = ARTransformer(ARConfig(n_layer=4)).eval().cuda().to(dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    cond = torch.randn((2, 256, 768), generator=g, device="cuda")
    prompt = torch.randint(0, 2048, (2, 64), generator=g, device="cuda")
    out = {}
    for graph in (True, False):
        gen = ARGenerator(model, 48, graph=graph)
        tokens, n = gen.generate(cond, torch.tensor([256, 100]), prompt, torch.tensor([40, 9]),
                                 seed=3)
        out[graph] = tokens.cpu(), n.cpu(), gen
    assert torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1])
    g_gen = out[True][2]
    assert g_gen.graph is not None and g_gen.replays == g_gen.decode_steps - 1 > 0
    assert g_gen.graph_launches == {"k1": 0, "k2": 0, "k3": 0}
    assert out[False][2].replays == 0


def test_ar_decode_graph_cap_and_kept_logits_match_eager():
    """Per-row caps act inside the captured step: the replayed decode stops
    each row where the eager one does, and the logits it keeps are the eager
    step's; a profiler-free timer records the decode's counters."""
    from seedvc_tpu_torch.core.profiling import StageTimer
    from seedvc_tpu_torch.models.ar import CHECK_EVERY, ARConfig, ARGenerator, ARTransformer

    torch.manual_seed(0)
    model = ARTransformer(ARConfig(n_layer=4)).eval().cuda().to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    cond = torch.randn((2, 256, 768), generator=g, device="cuda")
    prompt = torch.randint(0, 2048, (2, 64), generator=g, device="cuda")
    out = {}
    for graph in (True, False):
        gen = ARGenerator(model, 160, graph=graph)
        timer = StageTimer(record=True, device="cuda")
        tokens, n = gen.generate(cond, torch.tensor([256, 100]), prompt, torch.tensor([40, 9]),
                                 seed=3, max_tokens=torch.tensor([17, 70]), keep_logits=True,
                                 timer=timer)
        out[graph] = tokens.cpu(), n.cpu(), gen.logits.cpu(), timer.report()["ar.decode"], gen
    (tg, ng, lg, rg, gen), (te, ne, le, re, _) = out[True], out[False]
    assert torch.equal(tg, te) and torch.equal(ng, ne) and (ng <= torch.tensor([17, 70])).all()
    # every row done by step 69: the decode stops at a read of all(done)
    steps = gen.decode_steps
    assert steps < 159 and steps % CHECK_EVERY == 0
    assert torch.equal(lg[: steps + 1], le[: steps + 1])
    assert rg["steps"] == steps and rg["tokens"] == int(ng.sum()) and rg["captures"] == 1
    assert rg["replays"] == steps - 1 and re["replays"] == re["captures"] == 0
    assert rg["device_seconds"] > 0


# --- the AR decode chain (ops/ar_decode.py) against its plain twins ----------

AR_KV = {"prefill_end": 600, "mid_cache": 2000, "past_the_end": 4100}


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _ar_tol(dtype):
    """bf16: one rounding of the output apart (2^-7) where the sums' order
    differs, and 3e-3 in the relative L2 norm; f32: the order alone."""
    return (dict(atol=1e-2, rtol=2 ** -7), 3e-3) if dtype == torch.bfloat16 else (
        dict(atol=2e-5, rtol=2e-5), 1e-5)


def _ar_case(B, kv, seed, dtype):
    """Full-width caches (B, 2, 4096, 64) drawn in every slot, kv_pos, per-row
    min_key (None for one row) and input positions (the first past the table)."""
    from seedvc_tpu_torch.models.ar import ARConfig

    c = ARConfig()
    kc = _randn(seed, B, c.n_local_heads, c.max_seq_len, c.head_dim).to(dtype)
    vc = _randn(seed + 1, B, c.n_local_heads, c.max_seq_len, c.head_dim).to(dtype)
    last = min(kv, c.max_seq_len - 1)
    mk = None if B == 1 else torch.tensor([(97 * b) % (last + 1) for b in range(B)],
                                          device="cuda")
    pos = torch.tensor([4150] + [(kv - 300 + 811 * b) % 4096 for b in range(1, B)],
                       device="cuda")
    return c, kc, vc, torch.tensor(kv, device="cuda"), mk, pos


@pytest.mark.parametrize("kv", list(AR_KV.values()), ids=list(AR_KV))
@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ar_attn_in_kernel_matches_twin(dtype, B, kv):
    from seedvc_tpu_torch.nn.layers import rope_cache
    from seedvc_tpu_torch.ops import ar_decode

    c, kc, vc, kv_pos, _, pos = _ar_case(B, kv, 300, dtype)
    x = _randn(302, B, c.dim).to(dtype)
    norm_w = (1 + 0.5 * _randn(303, c.dim)).to(dtype)
    wqkv = (_randn(304, (c.n_head + 2 * c.n_local_heads) * 64, c.dim) / 28).to(dtype)
    rope = torch.from_numpy(rope_cache(c.max_seq_len, 64)).cuda()
    outs = []
    for fn in (ar_decode.attn_in, ar_decode.attn_in_reference):
        q = torch.zeros(B, c.n_head, 64, device="cuda", dtype=dtype)
        k2, v2 = kc.clone(), vc.clone()
        fn(x, norm_w, wqkv, rope, pos, kv_pos, q, k2, v2, c.norm_eps)
        outs.append((q, k2, v2))
    torch.cuda.synchronize()
    tol, rel = _ar_tol(dtype)
    slot = min(kv, c.max_seq_len - 1)
    for got, ref in zip(outs[0], outs[1]):
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        assert _rel(got, ref) <= rel
    for got, old in ((outs[0][1], kc), (outs[0][2], vc)):  # only the slot written
        keep = torch.arange(c.max_seq_len, device="cuda") != slot
        assert torch.equal(got[:, :, keep], old[:, :, keep])
        assert not torch.equal(got[:, :, slot], old[:, :, slot])


@pytest.mark.parametrize("kv", list(AR_KV.values()), ids=list(AR_KV))
@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ar_attention_kernel_matches_twin(dtype, B, kv):
    """Every row attends [min_key[b], min(kv_pos, 4095)]; NaN planted in every
    other slot leaves the kernel's output finite and bit for bit as it was."""
    from seedvc_tpu_torch.ops import ar_decode

    c, kc, vc, kv_pos, mk, _ = _ar_case(B, kv, 310, dtype)
    q = (3 * _randn(312, B, c.n_head, 64)).to(dtype)  # peaked, as a trained LM's
    s = ar_decode.new_scratch(B, c, "cuda", dtype)
    ref = torch.empty_like(s.attn)
    ar_decode.attention(q, kc, vc, kv_pos, mk, s.attn, s.part, s.counters)
    ar_decode.attention_reference(q, kc, vc, kv_pos, mk, ref)
    out = s.attn.clone()
    torch.cuda.synchronize()
    tol, rel = _ar_tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert _rel(out, ref) <= rel
    assert not s.counters.any()  # the last block of each (row, KV head) reset its counter
    keys = torch.arange(c.max_seq_len, device="cuda")[None, :]
    low = mk[:, None] if mk is not None else 0
    outside = ((keys > kv_pos) | (keys < low))[:, None, :, None]
    for cache in (kc, vc):
        cache.masked_fill_(outside, float("nan"))
    ar_decode.attention(q, kc, vc, kv_pos, mk, s.attn, s.part, s.counters)
    torch.cuda.synchronize()
    assert torch.isfinite(s.attn).all() and torch.equal(s.attn, out)


@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["attn_out", "ffn_in", "ffn_out", "head"])
def test_ar_product_kernels_match_twins(kernel, dtype, B):
    from seedvc_tpu_torch.models.ar import ARConfig
    from seedvc_tpu_torch.ops import ar_decode

    c = ARConfig()
    D, I, V = c.dim, c.intermediate_size, c.vocab_size

    def w(seed, *shape):
        return (_randn(seed, *shape) / shape[-1] ** 0.5).to(dtype)
    x = _randn(320, B, D).to(dtype)
    norm_w = (1 + 0.5 * _randn(321, D)).to(dtype)
    if kernel == "attn_out":
        args = lambda: (_randn(322, B, D).to(dtype), w(323, D, D), x,  # noqa: E731
                        torch.zeros_like(x))
    elif kernel == "ffn_in":
        args = lambda: (x, norm_w, w(324, I, D), w(325, I, D),  # noqa: E731
                        torch.zeros(B, I, device="cuda", dtype=dtype), c.norm_eps)
    elif kernel == "ffn_out":
        args = lambda: (_randn(326, B, I).to(dtype), w(327, D, I), x.clone())  # noqa: E731
    else:
        args = lambda: (x, norm_w, w(328, V, D),  # noqa: E731
                        torch.zeros(B, V, device="cuda"), c.norm_eps)
    got, ref = args(), args()
    getattr(ar_decode, kernel)(*got)
    getattr(ar_decode, f"{kernel}_reference")(*ref)
    torch.cuda.synchronize()
    out = {"attn_out": 3, "ffn_in": 4, "ffn_out": 2, "head": 3}[kernel]
    tol, rel = _ar_tol(dtype if kernel != "head" else torch.float32)
    if kernel == "head" and dtype == torch.bfloat16:  # f32 sums of bf16 products
        tol, rel = dict(atol=1e-4, rtol=1e-4), 1e-5
    torch.testing.assert_close(got[out].float(), ref[out].float(), **tol)
    assert _rel(got[out], ref[out]) <= rel


def _ar_full(dtype, seed=0):
    """ARConfig() at random weights (q/k/v 3x wider, so attention peaks as a
    trained LM's), and caches filled by a packed prefill of 3 rows."""
    from seedvc_tpu_torch.models.ar import ARConfig, ARTransformer

    torch.manual_seed(seed)
    model = ARTransformer(ARConfig()).eval()
    with torch.no_grad():
        for i in range(model.cfg.n_layer):
            getattr(model, f"layers_{i}").attention.wqkv.weight.mul_(3.0)
    return model.cuda().to(dtype)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ar_decode_chain_matches_plain_step(dtype, B):
    """The whole fused step against the plain step on the same caches (a
    prefill of 600 positions, rows left-padded): the logits within the
    plain bf16 step's own distance from f32 (and under 0.03), the same slot
    written in every layer and no other; NaN planted outside each row's
    [min_key, kv_pos] leaves the fused logits finite and unchanged."""
    from seedvc_tpu_torch.ops import ar_decode

    model = _ar_full(dtype)
    c = model.cfg
    L = 600
    g = torch.Generator(device="cuda").manual_seed(5)
    emb = torch.randn((B, L, c.dim), generator=g, device="cuda").to(dtype)
    pos = torch.arange(L, device="cuda")[None].expand(B, L)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device="cuda"))[None, None].expand(
        B, 1, L, L)
    kc, vc = model.new_caches(B, "cuda", dtype)
    with torch.no_grad():
        model.prefill(emb, pos, mask, kc, vc)
        x = torch.randn((B, 1, c.dim), generator=g, device="cuda").to(dtype)
        in_pos, kv = torch.full((B,), L, device="cuda"), torch.tensor(L, device="cuda")
        mk = torch.tensor([0, 41, 300][:B], device="cuda")
        caches = {k: (kc.clone(), vc.clone()) for k in ("fused", "plain", "f32")}
        scratch = ar_decode.new_scratch(B, c, "cuda", dtype)
        fused = model.decode_step(x, in_pos, kv, *caches["fused"], mk, scratch=scratch)
        plain = model.decode_step_reference(x, in_pos, kv, *caches["plain"], mk)
        f32 = model.float().decode_step_reference(x.float(), in_pos, kv,
                                                  *(t.float() for t in caches["f32"]), mk)
        model.to(dtype)
        err_fused, err_plain = _rel(fused, f32), _rel(plain, f32)
        if dtype == torch.bfloat16:
            assert err_fused <= 1.1 * err_plain + 1e-3 and _rel(fused, plain) < 0.03, (
                err_fused, err_plain)
        else:
            assert _rel(fused, plain) < 1e-4
        keep = torch.arange(c.max_seq_len, device="cuda") != L
        for a, b in zip(caches["fused"], caches["plain"]):
            assert torch.equal(a[:, :, :, keep], b[:, :, :, keep])
            assert _rel(a[:, :, :, L], b[:, :, :, L]) < (0.03 if dtype == torch.bfloat16
                                                         else 1e-4)
        outside = ((torch.arange(c.max_seq_len, device="cuda")[None] > L)
                   | (torch.arange(c.max_seq_len, device="cuda")[None] < mk[:, None]))
        poisoned = (kc.clone(), vc.clone())
        for t in poisoned:
            t.masked_fill_(outside[None, :, None, :, None], float("nan"))
        clean = fused.clone()
        again = model.decode_step(x, in_pos, kv, *poisoned, mk, scratch=scratch)
        assert torch.isfinite(again).all() and torch.equal(again, clean)


def test_ar_decode_step_on_the_card_needs_a_scratch_and_a_group_of_six():
    """On cuda the step needs a scratch to write into, and a model whose KV
    head serves other than 6 query heads raises at the attention wrapper,
    after the first layer's ``attn_in`` and before the attention launches."""
    from seedvc_tpu_torch.models.ar import ARConfig, ARTransformer
    from seedvc_tpu_torch.ops import ar_decode

    for cfg, match in ((ARConfig(n_layer=1), "scratch"),
                       (ARConfig(dim=256, n_layer=1, n_head=4), "4 query heads over 2")):
        model = ARTransformer(cfg).eval().cuda()
        kc, vc = model.new_caches(1, "cuda", torch.float32)
        scratch = None if match == "scratch" else ar_decode.new_scratch(1, cfg, "cuda",
                                                                        torch.float32)
        launches = ar_decode.LAUNCHES
        with torch.no_grad(), pytest.raises(ValueError, match=match):
            model.decode_step(torch.zeros((1, 1, cfg.dim), device="cuda"),
                              torch.zeros(1, dtype=torch.long, device="cuda"),
                              torch.tensor(0, device="cuda"), kc, vc, scratch=scratch)
        assert ar_decode.LAUNCHES == launches + (0 if match == "scratch" else 1)


def test_ar_decode_replay_runs_the_chain_and_no_library_product():
    """One replay of the captured decode step at ARConfig() (bf16, 2 rows):
    a torch.profiler trace counts at most 130 kernels and no cuBLAS or
    CUTLASS product; the capture counted 5 x 12 + 1 = 61 launches of the
    chain (``fused_launches``), and each wrapper counted its kernel for the
    first decode step (run eagerly) and the capture."""
    from torch.profiler import ProfilerActivity, profile

    from seedvc_tpu_torch.core.profiling import StageTimer
    from seedvc_tpu_torch.models.ar import ARGenerator
    from seedvc_tpu_torch.ops import ar_decode

    model = _ar_full(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    cond = torch.randn((2, 256, 768), generator=g, device="cuda")
    prompt = torch.randint(0, 2048, (2, 64), generator=g, device="cuda")
    gen = ARGenerator(model, 40)
    timer = StageTimer(record=True, device="cuda")
    before = dict(ar_decode.KERNEL_LAUNCHES)
    gen.generate(cond, torch.tensor([256, 100]), prompt, torch.tensor([40, 9]), seed=3,
                 timer=timer)
    dec = timer.report()["ar.decode"]
    n = model.cfg.n_layer
    assert gen.fused_launches == 5 * n + 1 == 61
    assert dec["steps"] == gen.decode_steps == gen.replays + 1 > 1 and gen.captures == 1
    assert {k: v - before[k] for k, v in ar_decode.KERNEL_LAUNCHES.items()} == {
        k: 2 * (1 if k == "head" else n) for k in ar_decode.KERNELS}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen.graph.replay()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type().name == "CUDA" and not e.is_user_annotation()
             and not e.name().startswith(("Memcpy", "Memset"))]
    chain = [k for k in names if "gemv_kernel" in k or "attention_kernel" in k]
    libs = [k for k in names if any(w in k.lower() for w in ("nvjet", "xmma", "gemm", "cublas",
                                                             "cutlass"))]
    # the counter holds the chain's launches exactly; the trace shows them, and a
    # session of this profiler can drop its edge records, so it bounds them only
    assert 0 < len(chain) <= 61 and not libs, (len(chain), libs)
    assert len(names) <= 130, (len(names), sorted(set(names)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_replays_in_a_cuda_graph(dtype):
    """K1 captured in a CUDA graph (as the streaming block program captures
    it): the capture counts one launch, a replay on new inputs written into
    the static buffers equals an eager call on them, bit for bit."""
    T = 331
    q, k, v = (_randn(s + 50, 2, 6, T, 64).to(dtype) for s in range(3))
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
    attention.dit_attention_fused(q, k, v, cos, sin)  # build, load, set attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = attention.LAUNCHES
    with torch.cuda.graph(graph):
        out = attention.dit_attention_fused(q, k, v, cos, sin)
    assert attention.LAUNCHES == before + 1
    for s in (60, 70):
        for i, t in enumerate((q, k, v)):
            t.copy_(_randn(s + i, 2, 6, T, 64).to(dtype))
        graph.replay()
        torch.testing.assert_close(out, attention.dit_attention_fused(q, k, v, cos, sin),
                                   atol=0, rtol=0)


@pytest.fixture(scope="module")
def full_cfm():
    """``whisper_small_wavenet``'s CFM at full width (DiT 512 wide, 13
    layers, WaveNet head), bf16 on the card; its zero-initialised output
    layers drawn, so the velocity is not 0."""
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.models.cfm import CFM

    if not torch.cuda.is_available():  # module scope: before the autouse skip
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    model = CFM(get_preset("whisper_small_wavenet").model_params).eval()
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0, 0.02)
    return model.requires_grad_(False).cuda().to(torch.bfloat16)


def _sampler_args(T, seed, prompt_len, n_valid):
    """A conversion chunk's sampler inputs at context T: noise, mu, lens,
    prompt, prompt_len, style (B = 1, so the CFG stack has 2 rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    return (r(1, T, 80), r(1, T, 512), torch.tensor([n_valid], device="cuda"), r(1, T, 80),
            prompt_len, r(1, 192))


def _eager_and_graphed(model, sampler, args, steps=25):
    """(eager mel, graphed mel, K1 launches of each call)."""
    from seedvc_tpu_torch.models.cfm import euler_solve

    n0 = attention.LAUNCHES
    want = euler_solve(model.estimate, *args, n_timesteps=steps, cfg_rate=0.7,
                       precompute_fn=model.precompute_cond)
    n1 = attention.LAUNCHES
    got = sampler(*args, n_timesteps=steps, cfg_rate=0.7)
    torch.cuda.synchronize()
    return want, got, (n1 - n0, attention.LAUNCHES - n1)


def test_euler_graph_matches_eager_at_full_width(full_cfm):
    """The graphed sampler (one CUDA graph an Euler step) against the eager
    loop at ``whisper_small_wavenet``'s DiT, a (2, 2048) CFG stack, 25 steps,
    lens set: bit for bit (the same kernels on the same inputs, in the same
    order), the capturing call and a replaying one with a new prompt length."""
    from seedvc_tpu_torch.models.cfm import EulerGraph

    sampler = EulerGraph(full_cfm.estimate, full_cfm.precompute_cond)
    for seed, prompt_len, n_valid in ((1, 512, 1966), (2, 300, 2048)):
        want, got, _ = _eager_and_graphed(full_cfm, sampler,
                                          _sampler_args(2048, seed, prompt_len, n_valid))
        assert (got.float() - want.float()).abs().max().item() == 0.0
        assert not got[:, prompt_len:].isnan().any() and got[:, :prompt_len].abs().max() == 0
    assert len(sampler.graphs) == 1
    step = next(iter(sampler.graphs.values()))
    assert step.launches == {"k1": 13, "k2": 0, "k3": 0}  # K1 once a layer, no K3, no K2


def test_euler_graph_replays_two_contexts_in_turn(full_cfm):
    """Two contexts (2048, 1536) captured and replayed in turn, each call
    still equal to the eager loop; a third use of each captures nothing."""
    from seedvc_tpu_torch.models.cfm import EulerGraph

    sampler = EulerGraph(full_cfm.estimate, full_cfm.precompute_cond)
    for seed, T in ((3, 2048), (4, 1536), (5, 2048), (6, 1536)):
        want, got, _ = _eager_and_graphed(full_cfm, sampler, _sampler_args(T, seed, 400, T - 90))
        assert (got.float() - want.float()).abs().max().item() == 0.0
        assert len(sampler.graphs) == (1 if seed == 3 else 2)
    graphs = dict(sampler.graphs)
    _eager_and_graphed(full_cfm, sampler, _sampler_args(2048, 7, 400, 1000), steps=3)
    assert all(sampler.graphs[k] is v for k, v in graphs.items())


def test_euler_graph_launch_counters_count_what_ran(full_cfm):
    """``attention.LAUNCHES`` advances by exactly steps × depth over a
    graphed call, the capturing one included (its first step runs eagerly,
    the capture counts nothing), as over the eager loop; K2 and K3 not at all."""
    from seedvc_tpu_torch.models.cfm import EulerGraph

    sampler = EulerGraph(full_cfm.estimate, full_cfm.precompute_cond)
    others = (attention.DIT_ATTENTION_LAUNCHES, anti_alias.LAUNCHES)
    for steps in (2, 25, 1):
        _, _, (eager, graphed) = _eager_and_graphed(
            full_cfm, sampler, _sampler_args(1024, steps, 256, 1000), steps=steps)
        assert eager == graphed == steps * 13
    assert (attention.DIT_ATTENTION_LAUNCHES, anti_alias.LAUNCHES) == others


def test_voice_converter_graph_matches_eager_conversion():
    """A 2-chunk conversion at full width (``whisper_small_wavenet``, random
    weights; context 1024): its wave with the graphed sampler equals the
    eager one's, every step counts as ``graphed_steps``, and K1 ran steps ×
    13 a chunk by the counter."""
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    vc = VoiceConverter(context_frames=1024, prompt_cap_frames=256, seed=3)
    assert vc._use_graph
    sr = vc.sr
    t = np.arange(12 * sr) / sr
    src = (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
    ref = (0.3 * np.sin(2 * np.pi * 230 * t[: 4 * sr])).astype(np.float32)
    out = {}
    for graph in (False, True, False, True):
        vc._use_graph = graph
        n0 = attention.LAUNCHES
        _, wave, stats = vc.convert(src, sr, ref, sr, diffusion_steps=10, seed=1)
        sample = stats["stages"]["sample"]
        assert stats["chunks"] == 2 and sample["steps"] == 20
        assert sample["graphed_steps"] == (20 if graph else 0)
        assert attention.LAUNCHES - n0 == 20 * 13
        out.setdefault(graph, []).append(wave)
    assert np.array_equal(out[True][0], out[False][0]) and np.abs(out[True][0]).max() > 0
    assert np.array_equal(out[True][1], out[False][1])
    assert len(vc.sampler.graphs) == 1


def _kernel_launches(prof) -> dict:
    """K1's and K2's launches among a ``torch.profiler`` session's device
    operations, CUDA graph replays included (by K1's core kernel, which K3
    shares, so "k1" counts K3 too)."""
    names = {"k1": "attn_core_kernel", "k2": "anti_alias_snake_kernel"}
    out = {k: 0 for k in names}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and not e.is_user_annotation():
            for k, name in names.items():
                out[k] += name in e.name()
    return out


def test_voice_converter_launch_counters_match_the_trace():
    """The kernel counters against the device's own record: over a graphed
    2-chunk conversion (the one that captures, then one that only replays),
    K1's and K2's counters advance by the K1 cores and K2 kernels that a
    ``torch.profiler`` trace of the conversion shows ran (K1 steps × 13)."""
    from torch.profiler import ProfilerActivity, profile

    from seedvc_tpu_torch.ops import launches
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    vc = VoiceConverter(context_frames=1024, prompt_cap_frames=256, seed=4)
    sr = vc.sr
    t = np.arange(12 * sr) / sr
    src = (0.3 * np.sin(2 * np.pi * 170 * t)).astype(np.float32)
    ref = (0.3 * np.sin(2 * np.pi * 210 * t[: 4 * sr])).astype(np.float32)
    vc._use_graph = False
    vc.convert(src, sr, ref, sr, diffusion_steps=2, seed=1)  # kernel builds, off the trace
    vc._use_graph = True
    for call in ("capture", "replay"):
        n0 = launches.counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, stats = vc.convert(src, sr, ref, sr, diffusion_steps=10, seed=1)
            torch.cuda.synchronize()
        counted = {k: v - n0[k] for k, v in launches.counts().items()}
        traced = _kernel_launches(prof)
        assert stats["chunks"] == 2 and stats["stages"]["sample"]["graphed_steps"] == 20, call
        assert counted["k3"] == 0, call
        assert traced == {"k1": counted["k1"], "k2": counted["k2"]}, (call, traced, counted)
        assert counted["k1"] == 20 * 13 and counted["k2"] > 0, call
    assert len(vc.sampler.graphs) == 1


def _full_dit_v2():
    """``DiTV2Config()`` (512 wide, 13 layers, time and style as tokens),
    bf16 on the card, its zero-initialised layers (AdaLN-Zero) drawn, and its
    ``(estimate, precompute)`` as ``VoiceConverterV2`` hands them to the
    sampler."""
    from seedvc_tpu_torch.models.dit_v2 import DiTV2, DiTV2Config

    torch.manual_seed(0)
    dit = DiTV2(DiTV2Config()).eval()
    with torch.no_grad():
        for p in dit.parameters():
            if not p.abs().sum():
                p.normal_(0, 0.02)
    dit = dit.requires_grad_(False).cuda().to(torch.bfloat16)

    def estimate(x, px, lens, t, s, m, sc=None):
        return dit(x, px, lens, t, s, m, static_cond=sc)

    def precompute(x, px, lens, s, m):
        return dit(x, px, lens, torch.zeros(x.shape[0], device=x.device), s, m,
                   return_static=True)
    return estimate, precompute


V2_KW = dict(cfg_rates=(0.7, 0.7), random_voice=False)  # the 3-branch stack


def test_v2_euler_graph_matches_eager_at_full_width():
    """v2's sampler graphed (one CUDA graph an Euler step) against its eager
    loop at ``DiTV2Config()``, the 3-branch CFG stack, 30 cosine steps, lens
    set, keeping every step's state and combined estimate: bit for bit (the
    same kernels on the same inputs, in the same order), the mel and every
    kept row, at two contexts (2558, 2046) captured and replayed in turn
    with new prompt lengths. K1 runs steps × 13 by the counter either way."""
    from seedvc_tpu_torch.models.cfm import EulerGraph
    from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg

    estimate, precompute = _full_dit_v2()
    sampler = EulerGraph(estimate, precompute)
    steps = 30
    kw = dict(n_timesteps=steps, precompute_fn=precompute, **V2_KW)
    for seed, T, prompt_len in ((1, 2558, 768), (2, 2046, 300), (3, 2558, 401),
                                (4, 2046, 768)):
        args = _sampler_args(T, seed, prompt_len, T - 90)
        kept = torch.zeros((2, 2, steps, 1, T, 80), dtype=torch.bfloat16, device="cuda")
        n0 = attention.LAUNCHES
        want = euler_solve_multicfg(estimate, *args, **kw, keep=tuple(kept[0]))
        n1 = attention.LAUNCHES
        got = euler_solve_multicfg(estimate, *args, **kw, keep=tuple(kept[1]), graph=sampler)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(kept[1], kept[0]), (seed, T)
        assert not got[:, prompt_len:].isnan().any() and got[:, :prompt_len].abs().max() == 0
        assert kept[1][1].abs().amax(dim=(1, 2, 3)).min() > 0  # every step kept an estimate
        assert n1 - n0 == attention.LAUNCHES - n1 == steps * 13
        assert len(sampler.graphs) == (1 if seed == 1 else 2)
    assert all(g.launches == {"k1": 13, "k2": 0, "k3": 0} for g in sampler.graphs.values())


def test_v2_euler_graph_launch_counters_match_the_trace():
    """The kernel counters against the device's own record over v2's graphed
    sampler (the call that captures, then one that only replays): K1's
    counter advances by the K1 cores a ``torch.profiler`` trace shows ran
    (steps × 13), K2's and K3's not at all. The profile is taken in a fresh
    process: a session in a process that has already run many kernels can
    drop its edge records."""
    tests = Path(__file__).resolve().parent
    code = f"""
import json, sys
sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]
import torch
from torch.profiler import ProfilerActivity, profile
from seedvc_tpu_torch.models.cfm import EulerGraph
from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
from seedvc_tpu_torch.ops import launches
from test_torch_cuda import V2_KW, _full_dit_v2, _kernel_launches, _sampler_args
estimate, precompute = _full_dit_v2()
sampler = EulerGraph(estimate, precompute)
args = _sampler_args(2558, 5, 512, 2400)
kw = dict(precompute_fn=precompute, **V2_KW)
euler_solve_multicfg(estimate, *args, n_timesteps=1, **kw)  # kernel builds, off the trace
torch.cuda.synchronize()
out = []
for call in ("capture", "replay"):
    n0 = launches.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        euler_solve_multicfg(estimate, *args, n_timesteps=10, **kw, graph=sampler)
        torch.cuda.synchronize()
    counted = {{k: v - n0[k] for k, v in launches.counts().items()}}
    out.append([call, counted, _kernel_launches(prof)])
print(json.dumps(out))
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    for call, counted, traced in json.loads(run.stdout.splitlines()[-1]):
        assert counted == {"k1": 130, "k2": 0, "k3": 0}, (call, counted)
        assert traced == {"k1": counted["k1"], "k2": counted["k2"]}, (call, traced, counted)


def test_voice_converter_v2_graph_matches_eager_conversion():
    """A 2-chunk timbre conversion at ``V2Config()`` (random weights, 3 CFG
    branches, intermediates kept): its wave and every kept state and
    estimate with the graphed sampler equal the eager one's, and every step
    counts as ``graphed_steps``."""
    from seedvc_tpu_torch.pipelines.convert_v2 import VoiceConverterV2

    vc = VoiceConverterV2(seed=3)
    assert vc._use_graph
    sr = vc.sr
    t = np.arange(40 * sr) / sr
    src = (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
    ref = (0.3 * np.sin(2 * np.pi * 230 * t[: 4 * sr])).astype(np.float32)
    out = {}
    for graph in (False, True):
        vc._use_graph = graph
        _, wave, stats = vc.convert_timbre(src, sr, ref, sr, diffusion_steps=10, seed=1,
                                           keep_intermediates=True)
        sample = stats["stages"]["sample"]
        assert stats["chunks"] == 2 and sample["steps"] == 20
        assert sample["graphed_steps"] == (20 if graph else 0)
        out[graph] = wave, stats["kept"]["chunks"]
    assert np.array_equal(out[True][0], out[False][0]) and np.abs(out[True][0]).max() > 0
    for g, e in zip(out[True][1], out[False][1]):
        assert torch.equal(g["states"], e["states"]) and torch.equal(g["estimates"], e["estimates"])
    assert len(vc.sampler.graphs) == 1


@pytest.mark.parametrize("T", [2048, 777, 1])
def test_rope_prepass_matches_twin_exactly(T):
    """K1's pre-pass (roped q times 2^-3, roped k, bf16) equals its plain
    twin bit for bit: both round each product, the sum and the bf16 cast on
    their own."""
    q, k = (_randn(s, 2, 8, T, 64).bfloat16() for s in (7, 8))
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
    qo, ko = attention.rope_prepass(q, k, cos, sin)
    assert torch.equal(qo, attention.rope_scaled_reference(q, cos, sin, 0.125))
    assert torch.equal(ko, attention.rope_scaled_reference(k, cos, sin))


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("Tk,lens,slab", [(2048, (1966, 1966), (1024, 2048)),
                                          (2048, (0, 1966), (0, 1024)),
                                          (2048, (1, 1477), (1024, 2048)),
                                          (2560, None, (1281, 2560)), (777, (700, 300), (5, 300))])
@pytest.mark.parametrize("dtype,tol,rel_tol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 1e-2, 2e-2)])
def test_attention_kernel_over_a_query_slab(Tk, lens, slab, dtype, tol, rel_tol, rope):
    """K1 and K3 with q of Tq rows (a rank's slab of a time-split sequence)
    against k, v of Tk: the twin on the same slab within the limits of
    test_attention_kernel_matches_twin, and each output row equal, bit for
    bit, to the same row of the whole sequence's (a query row is computed
    alone). K1 ropes q with the tables' rows at the slab's positions."""
    a, b = slab
    q, k, v = (_randn(s + 40, 2, 8, Tk, 64).to(dtype) for s in range(3))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    qs = q[:, :, a:b].contiguous()
    if rope:
        cos, sin = (torch.from_numpy(x).cuda() for x in rope_full_cache(Tk, 64))
        before = attention.LAUNCHES
        out = attention.dit_attention_fused(qs, k, v, cos, sin, lens_t,
                                            q_rope=(cos[a:b], sin[a:b]))
        assert attention.LAUNCHES == before + 1
        ref = attention.dit_attention_fused_reference(qs, k, v, cos, sin, lens_t,
                                                      (cos[a:b], sin[a:b]))
        whole = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
    else:
        before = attention.DIT_ATTENTION_LAUNCHES
        out = attention.dit_attention(qs, k, v, lens_t)
        assert attention.DIT_ATTENTION_LAUNCHES == before + 1
        ref = attention.dit_attention_reference(qs, k, v, lens_t)
        whole = attention.dit_attention(q, k, v, lens_t)
    assert out.shape == (2, 8, b - a, 64)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert (out.float() - ref.float()).norm() / ref.float().norm() <= rel_tol
    assert torch.equal(out, whole[:, :, a:b])


def test_attention_slab_lse_prepass_and_empty_slab():
    """K1 f32's log-sum-exp over a slab equals the whole's rows; the bf16
    pre-pass ropes a slab's q with its own tables bit for bit; an empty slab
    launches nothing; more query rows than keys raise."""
    Tk, (a, b) = 896, (300, 600)
    q, k, v = (_randn(s + 50, 2, 4, Tk, 64) for s in range(3))
    cos, sin = (torch.from_numpy(x).cuda() for x in rope_full_cache(Tk, 64))
    lens = torch.tensor([896, 1], dtype=torch.int32, device="cuda")
    qs = q[:, :, a:b].contiguous()
    _, lse = attention.dit_attention_fused(qs, k, v, cos, sin, lens, return_lse=True,
                                           q_rope=(cos[a:b], sin[a:b]))
    _, whole = attention.dit_attention_fused(q, k, v, cos, sin, lens, return_lse=True)
    assert torch.equal(lse, whole[:, :, a:b])
    qb, kb = qs.bfloat16(), k.bfloat16()
    qo, ko = attention.rope_prepass(qb, kb, cos, sin, (cos[a:b], sin[a:b]))
    assert torch.equal(qo, attention.rope_scaled_reference(qb, cos[a:b], sin[a:b], 0.125))
    assert torch.equal(ko, attention.rope_scaled_reference(kb, cos, sin))
    before = attention.LAUNCHES
    empty = attention.dit_attention_fused(qb[:, :, :0].contiguous(), kb, kb, cos, sin,
                                          q_rope=(cos[:0], sin[:0]))
    assert empty.shape == (2, 4, 0, 64) and attention.LAUNCHES == before
    with pytest.raises(ValueError, match="query rows"):
        attention.dit_attention(q, k[:, :, :5].contiguous(), v[:, :, :5].contiguous())


@pytest.mark.parametrize("n_kv,counter,other", [
    (None, "LAUNCHES", "DIT_ATTENTION_LAUNCHES"), (2, "DIT_ATTENTION_LAUNCHES", "LAUNCHES")],
    ids=["k1", "k3"])
def test_attention_module_takes_kernel_at_ragged_T(monkeypatch, n_kv, counter, other):
    """``Attention(use_flash=True)`` at T = 777, no multiple of 512: one K1
    launch (heads not grouped, rope_full given) or one K3 launch (2 KV heads
    for 8 query heads), and the same module through the plain twins agrees.
    f32 with TF32 off: the kernels' 1e-4."""
    from seedvc_tpu_torch.nn import layers

    T, H, hd = 777, 8, 64
    torch.manual_seed(0)
    m = layers.Attention(H * hd, H, n_local_heads=n_kv, use_flash=True).cuda()
    x = _randn(6, 2, T, H * hd)
    freqs = torch.from_numpy(layers.rope_cache(T, hd)).cuda()
    rope_full = None if n_kv else tuple(torch.from_numpy(a).cuda()
                                        for a in rope_full_cache(T, hd))
    lens = torch.tensor([700, 300], dtype=torch.int32, device="cuda")
    before = getattr(attention, counter), getattr(attention, other)
    with torch.no_grad():
        out = m(x, freqs, lens, rope_full)
    assert (getattr(attention, counter), getattr(attention, other)) == (before[0] + 1, before[1])
    monkeypatch.setattr(layers, "dit_attention_fused", attention.dit_attention_fused_reference)
    monkeypatch.setattr(layers, "dit_attention", attention.dit_attention_reference)
    with torch.no_grad():
        ref = m(x, freqs, lens, rope_full)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def _rel_l2(out, ref):
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("T,lens", [(896, None), (777, (700, 0)), (2560, (2558, 1)),
                                    (64, (1, 64)), (130, (300, 65))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_matches_twin(T, lens, dtype, rope):
    """K1ᵇ (dq, dk, dv of K1 or K3) against autograd through the twin, on the
    same CUDA inputs and the forward kernel's output, K1ᵇ computing the row
    statistics itself (no lse). f32: relative L2 norm 2e-6 and max abs 5e-6
    times the largest gradient (3xTF32 products and summation order); bf16:
    relative L2 5e-3. Cases: the training path's T = 896, a ragged T
    with a row whose keys are all masked (dv the mean of dO), K1's v2 shape
    with one valid key, T of one tile, lens past T."""
    q, k, v, g = (_randn(10 + s, 2, 8, T, 64).to(dtype) for s in range(4))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = attention.BWD_LAUNCHES
    if rope:
        cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
        o = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
        got = attention.dit_attention_fused_bwd(q, k, v, cos, sin, lens_t, o, g)
        ref = attention.dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens_t, g)
    else:
        o = attention.dit_attention(q, k, v, lens_t)
        got = attention.dit_attention_bwd(q, k, v, lens_t, o, g)
        ref = attention.dit_attention_bwd_reference(q, k, v, lens_t, g)
    torch.cuda.synchronize()
    assert attention.BWD_LAUNCHES == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            assert _rel_l2(a, b) <= 2e-6, name
            assert (a - b).abs().max().item() <= 5e-6 * b.abs().max().item(), name
        else:
            assert _rel_l2(a, b) <= 5e-3, name


# the v2 trainer's shapes: T = the 128-frame mel bucket + 2 prefix tokens
# (a last tile of two rows and keys), lens = mel frames + 2 of its clips
# (4.0 s with 4.4 s, 12 s with 11 s), a 0 entry and one valid key
V2_TRAIN_CASES = [(386, (346, 380)), (386, (0, 346)), (386, (380, 1)),
                  (1154, (1035, 949)), (1154, (0, 1035)), (1154, (1035, 1))]


@pytest.mark.parametrize("T,lens", V2_TRAIN_CASES)
def test_attention_kernels_at_v2_trainer_shapes(T, lens):
    """K1 f32 writing its log-sum-exp, and K1ᵇ f32 given it (as the autograd
    Function calls them in the v2 trainer), at (2, 8, T, 64): the output to
    1e-4 and the lse to 1e-5 of max(1, |lse|) against the twin; dq, dk, dv
    to 2e-6 relative L2 and 5e-6 of the largest gradient against autograd
    through the twin."""
    (got, ref, _) = _bwd_call(True, T, lens, torch.float32, 50, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_l2(a, b) <= 2e-6, name
        assert (a - b).abs().max().item() <= 5e-6 * b.abs().max().item(), name
    q, k, v = (_randn(50 + s, 2, 8, T, 64) for s in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
    out, lse = attention.dit_attention_fused(q, k, v, cos, sin, lens_t, return_lse=True)
    torch.testing.assert_close(out, attention.dit_attention_fused_reference(
        q, k, v, cos, sin, lens_t), atol=1e-4, rtol=0)
    lse_ref = attention.dit_attention_lse_reference(attention.rope_scaled_reference(q, cos, sin),
                                                    attention.rope_scaled_reference(k, cos, sin),
                                                    lens_t)
    assert ((lse - lse_ref).abs() <= 1e-5 * lse_ref.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("n_kv", [None, 2], ids=["k1", "k3"])
def test_attention_module_grad_on_card(n_kv):
    """``Attention(use_flash=True)`` in grad mode on the card: one forward
    launch (K1, or K3 with grouped heads) and one K1ᵇ launch, no twin; the
    input's and every weight's gradient agree with the same module on the
    CPU (the twins' autograd). f32, TF32 off: 1e-4 relative L2."""
    from seedvc_tpu_torch.nn import layers

    T, H, hd = 777, 8, 64
    torch.manual_seed(0)
    cpu = layers.Attention(H * hd, H, n_local_heads=n_kv, use_flash=True)
    card = layers.Attention(H * hd, H, n_local_heads=n_kv, use_flash=True)
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    x = _randn(7, 2, T, H * hd)
    w = _randn(8, 2, T, H * hd)
    lens = torch.tensor([700, 300], dtype=torch.int32)
    grads = []
    for m, dev in ((card, "cuda"), (cpu, "cpu")):
        xx = x.detach().to(dev).requires_grad_()
        freqs = torch.from_numpy(layers.rope_cache(T, hd)).to(dev)
        rope_full = None if n_kv else tuple(torch.from_numpy(a).to(dev)
                                            for a in rope_full_cache(T, hd))
        before = (attention.LAUNCHES, attention.DIT_ATTENTION_LAUNCHES, attention.BWD_LAUNCHES)
        (m(xx, freqs, lens.to(dev), rope_full) * w.to(dev)).sum().backward()
        after = (attention.LAUNCHES, attention.DIT_ATTENTION_LAUNCHES, attention.BWD_LAUNCHES)
        launched = tuple(a - b for a, b in zip(after, before))
        if dev == "cuda":
            assert launched == ((1, 0, 1) if n_kv is None else (0, 1, 1))
        else:
            assert launched == (0, 0, 0)
        grads.append([xx.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        assert _rel_l2(a.cpu(), b) <= 1e-4


def _bwd_call(rope, T, lens, dtype, seed, with_lse):
    """K1ᵇ on the forward kernel's output (and, with_lse, its row
    log-sum-exp, as the autograd Functions pass it); returns (got, twin's)."""
    q, k, v, g = (_randn(seed + s, 2, 8, T, 64).to(dtype) for s in range(4))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    if rope:
        cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
        o, lse = attention.dit_attention_fused(q, k, v, cos, sin, lens_t, return_lse=True)
        got = attention.dit_attention_fused_bwd(q, k, v, cos, sin, lens_t, o, g,
                                                lse if with_lse else None)
        ref = attention.dit_attention_fused_bwd_reference(q, k, v, cos, sin, lens_t, g)
    else:
        o, lse = attention.dit_attention(q, k, v, lens_t, return_lse=True)
        got = attention.dit_attention_bwd(q, k, v, lens_t, o, g, lse if with_lse else None)
        ref = attention.dit_attention_bwd_reference(q, k, v, lens_t, g)
    torch.cuda.synchronize()
    return got, ref, g


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("T,lens", [(896, (896, 1)), (777, (1, 0)), (64, (1, 64))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_one_valid_key_is_exact(T, lens, dtype, rope):
    """A batch row with exactly one valid key: the twin's autograd gives
    dq = dk = 0 exactly (P = (1, 0, ...)) and dv = the sum of dO at key 0,
    0 elsewhere; K1ᵇ writes that case on its own, so its zeros are exact
    too (a tensor-core dP would leave rounding noise). Sum: 1e-6 relative in
    f32, one bf16 rounding (2^-8) in bf16."""
    for with_lse in (True, False):
        (dq, dk, dv), ref, g = _bwd_call(rope, T, lens, dtype, 90, with_lse)
        b = lens.index(1)
        assert not dq[b].any() and not dk[b].any()
        assert not dv[b, :, 1:].any()
        total = g[b].float().sum(dim=1)
        tol = 1e-6 if dtype == torch.float32 else 2 ** -8
        assert ((dv[b, :, 0].float() - total).abs() <= tol * total.abs().max()).all()
        assert ((ref[0][b] == 0).all() and (ref[1][b] == 0).all())


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("T,lens", [(896, None), (777, (700, 0)), (2560, (2558, 1)),
                                    (130, (300, 65))])
def test_attention_kernel_lse_matches_twin(T, lens, rope):
    """The f32 forward kernel's row log-sum-exp (kept for K1ᵇ) against the
    plain one of the twin's masked logits: 1e-5 of max(1, |lse|) (f32
    logits from 3xTF32 products, exp2 and log in f32; with one valid key
    lse is that key's logit, which can lie near 0); -1e30 where no key is
    valid. chip_smoke.py's phase 3 uses the same limit."""
    q, k, v = (_randn(s + 30, 2, 8, T, 64) for s in range(3))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    if rope:
        cos, sin = (torch.from_numpy(a).cuda() for a in rope_full_cache(T, 64))
        _, lse = attention.dit_attention_fused(q, k, v, cos, sin, lens_t, return_lse=True)
        ref = attention.dit_attention_lse_reference(attention.rope_scaled_reference(q, cos, sin),
                                                    attention.rope_scaled_reference(k, cos, sin),
                                                    lens_t)
    else:
        _, lse = attention.dit_attention(q, k, v, lens_t, return_lse=True)
        ref = attention.dit_attention_lse_reference(q, k, lens_t)
    assert lse.shape == (2, 8, T) and lse.dtype == torch.float32
    assert ((lse - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("rope", [True, False], ids=["k1", "k3"])
@pytest.mark.parametrize("T,lens", [(896, None), (777, (700, 300)), (2560, (2476, 2558))])
def test_attention_bwd_lse_path_matches_path_without(T, lens, rope):
    """K1ᵇ given the forward's log-sum-exp (the training path) against K1ᵇ
    computing the statistics itself: the same arithmetic, so dk and dv agree
    bit for bit; dq is summed by atomics, whose order varies (1e-6 relative
    L2), and both stay within the f32 limits against the twin."""
    got, ref, _ = _bwd_call(rope, T, lens, torch.float32, 50, True)
    got2, _, _ = _bwd_call(rope, T, lens, torch.float32, 50, False)
    assert torch.equal(got[1], got2[1]) and torch.equal(got[2], got2[2])
    assert _rel_l2(got[0], got2[0]) <= 1e-6
    for a, b in zip(got, ref):
        assert _rel_l2(a, b) <= 2e-6
        assert (a - b).abs().max().item() <= 5e-6 * b.abs().max().item()


def test_attention_bwd_atomics_repeat():
    """dq is added up by atomics from the key tiles: two runs on the same
    inputs give dk and dv bit for bit and dq within 1e-6 relative L2 (the
    order of the f32 adds varies)."""
    runs = [_bwd_call(True, 2560, None, torch.float32, 60, True)[0] for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    assert _rel_l2(runs[0][0], runs[1][0]) <= 1e-6


def test_attention_bwd_checks_lse():
    x = torch.zeros((2, 1, 64, 64), device="cuda")
    with pytest.raises(ValueError, match="lse must be"):
        attention.dit_attention_bwd(x, x, x, None, x, x, torch.zeros((2, 64), device="cuda"))
    with pytest.raises(ValueError, match="lse must be"):
        attention.dit_attention_bwd(x, x, x, None, x, x,
                                    torch.zeros((2, 1, 64), device="cuda", dtype=torch.float64))


def test_attention_bwd_raises_when_build_fails(monkeypatch):
    """No fallback to the twin for K1ᵇ either."""
    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(attention, "load_library", broken)
    x = torch.zeros((1, 1, 64, 64), device="cuda")
    cs = torch.zeros((64, 64), device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        attention.dit_attention_fused_bwd(x, x, x, cs, cs, None, x, x)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        attention.dit_attention_bwd(x, x, x, None, x, x)


# K2 cases: the main path's largest and most frequent stage shapes, then the
# kernel's corners: T % 4 != 0 (scalar loads and stores), T of one tile (1016
# outputs, TT in anti_alias.cu) and one tile +- 1, two tiles + 1, T < 4 and
# T = 1 (both edge patches in one tile), B = 2, logscale off, and a large alpha
K2_CASES = [(1, 768, 6144, "default"), (1, 24, 393216, "default"), (2, 24, 3001, "default"),
            (1, 48, 7, "default"), (1, 8, 1, "default"), (1, 24, 3, "default"),
            (1, 24, 1016, "default"), (1, 24, 1015, "default"), (1, 24, 1017, "default"),
            (1, 8, 2033, "default"), (2, 96, 1000, "default"), (1, 32, 1001, "linear"),
            (2, 16, 4096, "linear"), (1, 24, 4099, "large_alpha")]
# the SVC path's BigVGAN-44k stage shapes of a 1536-frame chunk
K2_44K = [(1, 768, 12288, "default"), (1, 384, 49152, "default"), (1, 192, 98304, "default"),
          (1, 96, 196608, "default"), (1, 48, 393216, "default"), (1, 24, 786432, "default")]


def _k2_inputs(B, C, T, kind):
    """As chip_smoke.k2_inputs: "linear" takes alpha, beta = |N| + 0.5 with
    logscale off; "large_alpha" x ~ 2 N, log alpha ~ 3 + 0.3 N (|alpha u| up
    to a few hundred: the range reduction of sin^2) and log beta ~ 2.5 + 0.3 N,
    which keeps the function's gain 1 + alpha / e^beta on u's rounding (its
    summation order differs from cuDNN's) within the limit."""
    x = _randn(3, B, C, T)
    a, b = _randn(4, C), _randn(5, C)
    if kind == "linear":
        return x, a.abs() + 0.5, b.abs() + 0.5, False
    if kind == "large_alpha":
        return 2 * x, 3 + 0.3 * a, 2.5 + 0.3 * b, True
    return x, 0.3 * a, 0.3 * b, True


# the v2 path's BigVGAN-22k stage shapes of a 2046-frame chunk
K2_V2 = [(1, 768, 8184, "default"), (1, 384, 32736, "default"), (1, 192, 65472, "default"),
         (1, 96, 130944, "default"), (1, 48, 261888, "default"), (1, 24, 523776, "default")]


@pytest.mark.parametrize("B,C,T,kind", K2_CASES + K2_44K + K2_V2)
def test_anti_alias_kernel_matches_twin(B, C, T, kind):
    """fp32 FIR sums in another order, sin^2 by a polynomial -> 2e-5."""
    x, alpha, beta, logscale = _k2_inputs(B, C, T, kind)
    before = anti_alias.LAUNCHES
    out = anti_alias.anti_alias_snake(x, alpha, beta, logscale)
    assert anti_alias.LAUNCHES == before + 1
    torch.testing.assert_close(
        out, anti_alias.anti_alias_snake_reference(x, alpha, beta, logscale), atol=2e-5, rtol=0)


def test_anti_alias_call_is_one_device_kernel():
    """The wrapper does no device arithmetic of its own: one K2 call runs one
    device kernel (torch.profiler). The profile is taken in a fresh process:
    a session in a process that has already run many kernels can drop its
    edge records, here the one kernel."""
    tests = Path(__file__).resolve().parent
    code = f"""
import sys
sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from seedvc_tpu_torch.ops import anti_alias
from test_torch_cuda import _k2_inputs
x, alpha, beta, _ = _k2_inputs(1, 24, 4096, "default")
anti_alias.anti_alias_snake(x, alpha, beta)  # build and load outside the window
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    anti_alias.anti_alias_snake(x, alpha, beta)
    torch.cuda.synchronize()
print(sum(e.count for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation))
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split()[-1] == "1", run.stdout


def test_wrappers_raise_when_build_fails(monkeypatch):
    """No fallback to the twin: a CUDA tensor with no kernel is an error."""
    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(attention, "load_library", broken)
    monkeypatch.setattr(anti_alias, "load_library", broken)
    x = torch.zeros((1, 1, 64, 64), device="cuda", dtype=torch.bfloat16)
    cs = torch.zeros((64, 64), device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        attention.dit_attention_fused(x, x, x, cs, cs)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        attention.dit_attention(x, x, x)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        anti_alias.anti_alias_snake(torch.zeros((1, 4, 16), device="cuda"),
                                    torch.zeros(4, device="cuda"), torch.zeros(4, device="cuda"))


def test_wrappers_check_inputs():
    q = torch.zeros((1, 1, 64, 32), device="cuda", dtype=torch.bfloat16)
    cs = torch.zeros((64, 32), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        attention.dit_attention_fused(q, q, q, cs, cs)
    with pytest.raises(ValueError, match="head_dim"):
        attention.dit_attention(q, q, q)
    x = torch.zeros((2, 1, 64, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lens"):
        attention.dit_attention(x, x, x, torch.ones(2, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="k does not match"):
        attention.dit_attention(x, x.float(), x)
    with pytest.raises(ValueError, match="f32"):
        anti_alias.anti_alias_snake(torch.zeros((1, 4, 16), device="cuda").half(),
                                    torch.zeros(4, device="cuda"), torch.zeros(4, device="cuda"))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full_width"])
def test_rmvpe_cuda_matches_cpu(full):
    """RMVPE (cuDNN convolutions, cuDNN GRU, cuFFT STFT, TF32 off) against
    the same weights on the CPU, on 1 s of a vibrato tone: salience within
    1e-5 (an H100 read 1.8e-7 at full width on 3 s); decoded F0 within 1e-4
    relative on the frames whose salience peak clears both the 0.03
    threshold and the runner-up bin by 1e-3 (elsewhere f32 rounding may
    move the argmax)."""
    import copy

    from seedvc_tpu_torch.models.rmvpe import RMVPE, RMVPE_E2E, decode_f0

    torch.manual_seed(0)
    kw = {} if full else dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4)
    model = RMVPE_E2E(**kw).requires_grad_(False).eval()
    t = np.arange(16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * np.cumsum(180 * (1 + 0.05 * np.sin(6 * np.pi * t)))
                          / 16000)).astype(np.float32)[None]
    sal_cpu = RMVPE(copy.deepcopy(model)).salience(audio).numpy()[0]
    sal_cuda = RMVPE(model.cuda()).salience(audio).cpu().numpy()[0]
    np.testing.assert_allclose(sal_cuda, sal_cpu, atol=1e-5, rtol=0)
    top2 = np.sort(sal_cpu, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0] > 1e-3) & (top2[:, 1] > 0.03 + 1e-3)
    assert clear.mean() > 0.5
    f0_cpu, f0_cuda = decode_f0(sal_cpu), decode_f0(sal_cuda)
    np.testing.assert_allclose(f0_cuda[clear], f0_cpu[clear], rtol=1e-4)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full_width"])
def test_openvoice_cuda_matches_cpu(full):
    """The ToneColorConverter (cuDNN convolutions and GRU, TF32 off) against
    the same weights and noise on the CPU, on 2 s at 22.05 kHz: the speaker
    embeddings and the converted wave within 1e-5 absolute (f32
    through 16 WaveNet layers, 8 couplings and the decoder in other orders)."""
    import copy

    from seedvc_tpu_torch.models.openvoice import (OpenVoiceConfig, ToneColorConverter,
                                                   draw_post, linear_spectrogram)

    cfg = OpenVoiceConfig() if full else OpenVoiceConfig(
        inter_channels=32, hidden_channels=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),), upsample_initial_channel=64)
    torch.manual_seed(0)
    ov = draw_post(ToneColorConverter(cfg)).requires_grad_(False).eval()
    wave = torch.from_numpy((0.3 * np.sin(2 * np.pi * 180 * np.arange(44100) / 22050)
                             ).astype(np.float32))[None]
    out = {}
    for dev, m in (("cpu", copy.deepcopy(ov)), ("cuda", ov.cuda())):
        spec = linear_spectrogram(wave.to(dev))
        T = spec.shape[1]
        noise = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, T, cfg.inter_channels)).astype(np.float32)).to(dev)
        se = m.extract_se(spec)
        g_tgt = torch.flip(se, dims=(-1,))
        out[dev] = (se.cpu(), m.voice_conversion(spec, torch.tensor([T], device=dev), se,
                                                 g_tgt, noise, 0.3).cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-5, rtol=0)
    assert out["cpu"][1].abs().max() > 1e-3


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full_width"])
def test_wavlm_sv_cuda_matches_cpu(full):
    """WavLM-SV (cuDNN convolutions, TF32 off) against the same weights on the
    CPU on 3 s, within 1e-5 relative L2; on the card a padded 5 s bucket with
    ``lengths`` equals each clip's unpadded forward within 1e-5 relative L2."""
    import copy

    from seedvc_tpu_torch.models.wavlm_sv import WavLMSV, WavLMSVConfig

    cfg = WavLMSVConfig() if full else WavLMSVConfig(
        conv_dim=64, d_model=96, n_layers=2, n_heads=4, ffn_dim=192, pos_conv_kernel=32,
        pos_conv_groups=4, tdnn_dims=(64, 64, 64, 64, 128), xvector_dim=32)
    torch.manual_seed(0)
    m = WavLMSV(cfg).requires_grad_(False).eval()
    rng = np.random.default_rng(2)
    wave = torch.from_numpy((0.1 * rng.standard_normal((1, 48000))).astype(np.float32))
    ref = copy.deepcopy(m)(wave)
    m.cuda()
    got = m(wave.cuda()).cpu()
    assert ((got - ref).norm() / ref.norm()).item() < 1e-5
    lens = [48000, 31234]
    padded = torch.zeros(2, 80000)
    padded[0, :48000] = wave[0]
    padded[1, :31234] = torch.from_numpy((0.1 * rng.standard_normal(31234)).astype(np.float32))
    emb = m(padded.cuda(), lengths=torch.tensor(lens, device="cuda")).cpu()
    for i, n in enumerate(lens):
        solo = m(padded[i:i + 1, :n].cuda()).cpu()
        assert ((emb[i] - solo[0]).norm() / solo.norm()).item() < 1e-5
