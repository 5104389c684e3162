"""The port's CUDA kernels on the card (every test here is marked ``cuda``
and skips without a CUDA device).

This file imports nothing of JAX, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Each kernel is held to its plain PyTorch twin on the same CUDA inputs.
"""

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
    device kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, alpha, beta, _ = _k2_inputs(1, 24, 4096, "default")
    anti_alias.anti_alias_snake(x, alpha, beta)  # build and load outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        anti_alias.anti_alias_snake(x, alpha, beta)
        torch.cuda.synchronize()
    assert sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) == 1


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
