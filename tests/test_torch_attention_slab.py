"""K1 and K3 over a query slab (the sequence-sharded sampler's shape): q with
Tq rows of a sequence, k and v with all Tk rows. On the CPU the wrappers run
their plain twins; the slab's output must equal rows ``a:b`` of the whole
sequence's (the same f32 arithmetic row by row, 1e-6), with lens None, a 0
entry (every key masked) and one valid key. K1's q is roped with the rows
``a:b`` of the tables (``q_rope``); with the tables' first rows instead (a
rank's local positions) the rows differ. The kernels themselves are held on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.nn.layers import rope_full_cache
from seedvc_tpu_torch.ops import attention

torch.set_num_threads(1)

TOL = 1e-6
T, H = 40, 3
SLABS = [(0, 13), (13, 26), (26, 40), (5, 6)]
LENS = [None, (0, 31), (1, 40)]


def _inputs(lens, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, H, T, 64)).astype(np.float32))
               for _ in range(3))
    cos, sin = (torch.from_numpy(a) for a in rope_full_cache(T, 64))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return q, k, v, cos, sin, lens_t


@pytest.mark.parametrize("lens", LENS)
def test_k1_slab_equals_rows_of_the_whole(lens):
    q, k, v, cos, sin, lens_t = _inputs(lens)
    whole = attention.dit_attention_fused(q, k, v, cos, sin, lens_t)
    torch.testing.assert_close(
        whole, attention.dit_attention_fused_reference(q, k, v, cos, sin, lens_t), rtol=0, atol=0)
    for a, b in SLABS:
        qs = q[:, :, a:b].contiguous()
        got = attention.dit_attention_fused(qs, k, v, cos, sin, lens_t,
                                            q_rope=(cos[a:b], sin[a:b]))
        assert got.shape == (2, H, b - a, 64)
        torch.testing.assert_close(got, whole[:, :, a:b], rtol=0, atol=TOL)
        twin = attention.dit_attention_fused_reference(qs, k, v, cos, sin, lens_t,
                                                       (cos[a:b], sin[a:b]))
        torch.testing.assert_close(twin, got, rtol=0, atol=0)
        if a:  # q at local positions: the planted fault of the card's check
            bad = attention.dit_attention_fused(qs, k, v, cos, sin, lens_t,
                                                q_rope=(cos[: b - a], sin[: b - a]))
            assert (bad - whole[:, :, a:b]).abs().max() > 1e-3


@pytest.mark.parametrize("lens", LENS)
def test_k3_slab_equals_rows_of_the_whole(lens):
    q, k, v, _, _, lens_t = _inputs(lens, seed=1)
    whole = attention.dit_attention(q, k, v, lens_t)
    for a, b in SLABS:
        got = attention.dit_attention(q[:, :, a:b].contiguous(), k, v, lens_t)
        torch.testing.assert_close(got, whole[:, :, a:b], rtol=0, atol=TOL)
        out, lse = attention.dit_attention(q[:, :, a:b].contiguous(), k, v, lens_t,
                                           return_lse=True)
        assert lse.shape == (2, H, b - a)
        torch.testing.assert_close(
            lse, attention.dit_attention_lse_reference(q, k, lens_t)[:, :, a:b], rtol=0,
            atol=TOL)


def test_k1_slab_lse_and_prepass_take_the_q_tables():
    q, k, v, cos, sin, lens_t = _inputs((0, 31), seed=2)
    a, b = 13, 26
    qs = q[:, :, a:b].contiguous()
    _, lse = attention.dit_attention_fused(qs, k, v, cos, sin, lens_t, return_lse=True,
                                           q_rope=(cos[a:b], sin[a:b]))
    _, whole = attention.dit_attention_fused(q, k, v, cos, sin, lens_t, return_lse=True)
    torch.testing.assert_close(lse, whole[:, :, a:b], rtol=0, atol=TOL)
    qo, ko = attention.rope_prepass(qs, k, cos, sin, q_rope=(cos[a:b], sin[a:b]))
    qw, kw = attention.rope_prepass(q, k, cos, sin)
    assert torch.equal(qo, qw[:, :, a:b]) and torch.equal(ko, kw)


def test_empty_slab_and_shape_checks():
    q, k, v, cos, sin, lens_t = _inputs(None)
    empty = q[:, :, :0].contiguous()
    out = attention.dit_attention_fused(empty, k, v, cos, sin, lens_t, q_rope=(cos[:0], sin[:0]))
    assert out.shape == (2, H, 0, 64)
    assert attention.dit_attention(empty, k, v).shape == (2, H, 0, 64)
    # the kernels' checks: more query rows than keys, tables of the wrong length
    with pytest.raises(ValueError, match="query rows"):
        attention._check("k1", q, k[:, :, :5], v[:, :, :5], None)
    with pytest.raises(ValueError, match="q_rope cos"):
        attention._check("k1", q[:, :, :5], k, v, None, (("q_rope cos", cos, 5),))
    with pytest.raises(ValueError, match="query rows"):
        attention._check("k1b", q[:, :, :5].contiguous(), k, v, None, same_t=True)
