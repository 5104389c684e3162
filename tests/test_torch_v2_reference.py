"""The port's v2 path against the benchmark's frozen plain reference
(``vcbench/ref``: ``models/ar.py``, ``dit_v2.py``, ``cfm_v2.py``,
``pipelines/convert_v2.py``) on the CPU, tiny sizes
(``vcbench/tests/fixtures/tiny_v2.json``), both filled from one seeded draw
by the benchmark's builder.

The AR's packed, left-padded prefill and its decode through the KV cache
give the logits of the reference's full causal forward, row by row; a
per-row cap stops each row inside the decode step, its tokens a prefix of
the uncapped run's under the same draws; DiTV2 and the multi-condition
sampler match; the whole conversion matches the reference pipeline on the
same draws and noise; what ``keep_intermediates`` keeps is what the
conversion computed, and the reference's stages on the program's inputs to
them give it back; and ``profile=True`` records the ``ar`` spans and
counters with no synchronise of its own.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.core import profiling
from seedvc_tpu_torch.models.ar import ARGenerator
from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
from seedvc_tpu_torch.pipelines import convert_v2 as pconv
from vcbench.builders import v2_converter as builder
from vcbench.ref.models import ar as ref_ar
from vcbench.ref.models.cfm import cosine_t_span
from vcbench.ref.models.cfm_v2 import euler_solve_multicfg as ref_multicfg

torch.set_num_threads(1)
CFG = json.loads((Path(__file__).resolve().parents[1] / "vcbench" / "tests" / "fixtures"
                  / "tiny_v2.json").read_text())
SR = 22050
SEED = 2 ** 33 + 17


def _no_eos(*convs):
    """Every AR's EOS logit held at 0 and the others spread 10x wider, so
    EOS stays out of the top-p nucleus and rows run to their cap."""
    for c in convs:
        w = c.ar.output.weight.data
        w[: c.ar.cfg.eos] *= 10.0
        w[c.ar.cfg.eos] = 0.0


@pytest.fixture(scope="module")
def pair():
    prog = builder.program(CFG, torch.device("cpu"))
    ref = builder.reference(CFG, torch.device("cpu"))
    builder.fill(prog, CFG, SEED, "cpu")
    builder.fill(ref, CFG, SEED, "cpu")
    _no_eos(prog, ref)
    return prog, ref


def _rows(prog, ref, seed=3):
    """Two AR rows of different lengths: regulated conditions of 9 and 5
    narrow tokens, a 4-token prompt."""
    g = np.random.default_rng(seed)
    nc, nw = prog.cfg.narrow.codebook_size, prog.cfg.wide.codebook_size
    conds = [g.integers(0, nc, 9), g.integers(0, nc, 5)]
    cond_lens = np.array([9, 5])
    src = np.zeros((2, 64), np.int64)
    for b, c in enumerate(conds):
        src[b, : len(c)] = c
    prompt = g.integers(0, nw, 4)

    def emb(reg):
        return reg(torch.from_numpy(src), torch.from_numpy(cond_lens), 64,
                   x_lens=torch.tensor(9))[0]
    return emb(prog.ar_reg), emb(ref.ar_reg), cond_lens, prompt


def _generate(prog, cond_emb, cond_lens, prompt, draws, **kw):
    gen = ARGenerator(prog.ar, max_new_tokens=draws.shape[0], graph=False, device="cpu")
    P = np.zeros((2, 64), np.int64)
    P[:, : len(prompt)] = prompt
    tokens, n = gen.generate(cond_emb, torch.from_numpy(cond_lens), torch.from_numpy(P),
                             len(prompt), draws=draws, **kw)
    return gen, tokens.numpy(), n.numpy()


def _draws(n, vocab, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.empty(n, 2, vocab).exponential_(generator=g).clamp_min_(1e-30)


def test_decode_through_the_cache_gives_the_full_forward_logits(pair):
    prog, ref = pair
    emb_p, emb_r, cond_lens, prompt = _rows(prog, ref)
    draws = _draws(24, prog.cfg.ar.vocab_size)
    gen, tokens, n = _generate(prog, emb_p, cond_lens, prompt, draws, keep_logits=True)
    assert (n == 24).all() and gen.decode_steps == 23 and gen.captures == 0
    for b in range(2):
        want = ref.ar.teacher_forced(emb_r[b, : cond_lens[b]], torch.from_numpy(prompt),
                                     torch.from_numpy(tokens[b, : n[b]]))
        got = gen.logits[: n[b], b]
        assert torch.linalg.norm(got - want) / torch.linalg.norm(want) < 1e-5
        # the plain token-by-token decode draws the same tokens
        mine = ref_ar.generate(ref.ar, emb_r[b, : cond_lens[b]], torch.from_numpy(prompt),
                               draws, b, 24)
        np.testing.assert_array_equal(mine, tokens[b, : n[b]])


def test_each_row_stops_at_its_cap_with_a_prefix_of_the_uncapped_tokens(pair):
    prog, ref = pair
    emb_p, _, cond_lens, prompt = _rows(prog, ref, seed=4)
    draws = _draws(40, prog.cfg.ar.vocab_size, seed=6)
    _, free, n_free = _generate(prog, emb_p, cond_lens, prompt, draws)
    gen, capped, n_cap = _generate(prog, emb_p, cond_lens, prompt, draws,
                                   max_tokens=torch.tensor([7, 19]))
    assert list(n_free) == [40, 40] and list(n_cap) == [7, 19]
    for b, k in enumerate((7, 19)):
        np.testing.assert_array_equal(capped[b, :k], free[b, :k])
        assert (capped[b, k:] == 0).all()
    # both rows done by step 19: the decode stops at the next check of all(done)
    assert gen.decode_steps < 39
    _, one, n_one = _generate(prog, emb_p, cond_lens, prompt, draws, max_tokens=1)
    assert list(n_one) == [1, 1] and (one[:, 0] == free[:, 0]).all()


def _dit_inputs(prog, T=40, B=3, seed=7):
    g = torch.Generator().manual_seed(seed)
    c = prog.cfg.dit
    return (torch.randn(B, T, 80, generator=g), torch.randn(B, T, 80, generator=g),
            torch.tensor([T - 3, T, T - 10]), torch.rand(B, generator=g),
            torch.randn(B, c.style_encoder_dim, generator=g),
            torch.randn(B, T, c.content_dim, generator=g))


def test_ditv2_and_the_multi_condition_sampler_match(pair):
    prog, ref = pair
    args = _dit_inputs(prog)
    want = ref.dit(*args)
    np.testing.assert_allclose(prog.dit(*args).numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    x, px, lens, _, style, mu = (a[:1] for a in _dit_inputs(prog, T=48))
    prompt = torch.where(torch.arange(48)[None, :, None] < 10, px, torch.zeros_like(px))

    def sample(dit, solve):
        def est(x, p, l, t, s, m, sc=None):
            return dit(x, p, l, t, s, m, static_cond=sc)

        def pre(x, p, l, s, m):
            return dit(x, p, l, torch.zeros(x.shape[0]), s, m, return_static=True)
        return solve(est, x, mu, lens[:1], prompt, 10, style, n_timesteps=4,
                     cfg_rates=(0.7, 0.4), precompute_fn=pre)
    np.testing.assert_allclose(sample(prog.dit, euler_solve_multicfg).numpy(),
                               sample(ref.dit, ref_multicfg).numpy(), rtol=1e-4, atol=1e-4)


def _audio(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _noise_fn(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=g)


def _draws_fn(seed):
    return lambda shape: _draws(shape[0], shape[2], seed)[:, :1].expand(-1, shape[1], -1)


KW = dict(diffusion_steps=3, intelligibility_cfg_rate=0.7, similarity_cfg_rate=0.4)


@pytest.mark.parametrize("seconds,row_len", [(2.4, None), (3.3, 40)])
def test_convert_voice_matches_the_reference_pipeline(pair, seconds, row_len, monkeypatch):
    """Capped (uncapped, the tiny AR would run past its 1024 positions);
    ``row_len``: the AR rows' condition limit cut on both sides, so the
    source spreads over several rows."""
    prog, ref = pair
    if row_len:
        from vcbench.ref.pipelines import convert_v2 as rconv
        monkeypatch.setattr(pconv, "AR_MAX_CONTENT_LEN", row_len)
        monkeypatch.setattr(rconv, "AR_MAX_CONTENT_LEN", row_len)
    src, refw = _audio(seconds, 140, 1), _audio(1.0, 220, 2)
    _, wave, stats = prog.convert_voice(src, SR, refw, SR, noise_fn=_noise_fn(9),
                                        draws_fn=_draws_fn(8), cap_to_source=True,
                                        keep_intermediates=True, **KW)
    _, want, info = ref.convert_voice(src, SR, refw, SR, noise_fn=_noise_fn(9),
                                      draws_fn=_draws_fn(8), cap_to_source=True, **KW)
    tokens = stats["kept"]["tokens"]
    for k in ("src_narrow", "src_wide", "ref_narrow", "ref_wide", "wide"):
        np.testing.assert_array_equal(tokens[k], info[k])
    assert stats["target_len"] == info["target_len"] and len(wave) == len(want) > 0
    np.testing.assert_allclose(wave, want, atol=2e-3)
    rows = stats["kept"]["ar_rows"]
    assert stats["ar_batch"] == len(rows["n_tokens"]) and (stats["ar_batch"] > 1) == bool(row_len)
    # capped at the source: as many wide tokens as the source has frames
    assert rows["caps"].sum() == stats["narrow_tokens"] == info["wide"].shape[1]
    assert (rows["n_tokens"] == rows["caps"]).all()
    np.testing.assert_array_equal(tokens["wide"][0], np.concatenate(
        [rows["tokens"][b, :n] for b, n in enumerate(rows["n_tokens"])]))
    # the same wave from the reference run on the program's tokens
    _, again, _ = ref.convert_voice(src, SR, refw, SR, noise_fn=_noise_fn(9),
                                    tokens=tokens, **KW)
    np.testing.assert_array_equal(again, want)


def test_the_kept_intermediates_are_the_conversions_and_the_reference_gives_them_back(pair):
    """Keeping changes nothing of the conversion; the kept features and
    projections are the content stage's; each Euler step's state follows
    from the noise and the kept estimates by the update rule, and the
    reference's sampler at those states gives the kept estimates back;
    HuBERT and the quantizers on the program's inputs give theirs."""
    prog, ref = pair
    src, refw = _audio(2.6, 130, 5), _audio(1.0, 210, 6)
    kw = dict(noise_fn=_noise_fn(4), draws_fn=_draws_fn(2), cap_to_source=True, **KW)
    _, plain, _ = prog.convert_voice(src, SR, refw, SR, **kw)
    kw["noise_fn"] = _noise_fn(4)
    _, wave, stats = prog.convert_voice(src, SR, refw, SR, keep_intermediates=True, **kw)
    np.testing.assert_array_equal(wave, plain)
    kept = stats["kept"]
    _, _, src16, ref16 = ref.resampled(src, SR, refw, SR)
    for side, w16 in (("source", src16), ("reference", ref16)):
        k = kept[side]
        n = len(w16) // 320
        np.testing.assert_allclose(k["features"], ref.content_features(w16)[0], rtol=1e-4,
                                   atol=1e-4)
        for h, want in zip((k["narrow"], k["wide"]), ref.projections(k["features"][None])):
            np.testing.assert_allclose(h, want[0, :n], rtol=1e-4, atol=1e-5)
        narrow, wide = prog.content_tokens(w16)
        pn = prog.narrow.quantizer
        np.testing.assert_array_equal(pn.indices(k["narrow"][None])[:, :n], narrow)
    assert kept["ar_rows"]["logits"].shape[1] == stats["ar_batch"]
    t_span = cosine_t_span(KW["diffusion_steps"])
    states = [list(c["states"]) for c in kept["chunks"]]
    assert len(states) == stats["chunks"] and all(len(s) == 3 for s in states)
    noise = _noise_fn(4)
    for c, xs in zip(kept["chunks"], states):
        p0, w = c["p_len"], c["w"]
        z = noise((1, xs[0].shape[1], 80))
        assert torch.equal(xs[0][:, p0:], z[:, p0:]) and not xs[0][:, :p0].any()
        for i in range(len(xs) - 1):
            step = xs[i] + float(t_span[i + 1] - t_span[i]) * c["estimates"][i]
            torch.testing.assert_close(xs[i + 1][:, p0:], step[:, p0:])
    _, _, info = ref.convert_voice(src, SR, refw, SR, noise_fn=_noise_fn(4),
                                   tokens=kept["tokens"], states=states, **KW)
    assert len(info["estimates"]) == len(states)
    for c, est in zip(kept["chunks"], info["estimates"]):
        p0, w = c["p_len"], c["w"]
        for v, e in zip(c["estimates"], est):
            torch.testing.assert_close(v[:, p0: p0 + w], e[:, p0: p0 + w], rtol=1e-4,
                                       atol=1e-4)


def test_profile_records_the_ar_spans_and_counters_without_a_synchronise(pair, monkeypatch):
    prog, _ = pair
    syncs = []
    monkeypatch.setattr(pconv, "probe_ready", lambda x: syncs.append(1) or x)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    src, refw = _audio(2.0, 150, 3), _audio(1.0, 200, 4)
    for profile in (True, False):
        syncs.clear()
        _, _, stats = prog.convert_voice(src, SR, refw, SR, noise_fn=_noise_fn(1),
                                         cap_to_source=True, profile=profile, **KW)
        st = stats["stages"]
        # the stages before the sampler and each chunk: the syncs profiling had before
        assert len(syncs) == (3 + stats["chunks"] if profile else 0)
        assert {"ar", "ar.prefill", "ar.decode", "sample", "vocode"} <= set(st)
        dec = st["ar.decode"]
        assert dec["steps"] == stats["decode_steps"] and dec["rows"] == stats["ar_batch"]
        assert dec["tokens"] == stats["wide_tokens"] and dec["replays"] == dec["captures"] == 0
        assert st["sample"]["steps"] == 3 * stats["chunks"]
        assert st["ar"]["seconds"] >= st["ar.prefill"]["seconds"] + st["ar.decode"]["seconds"]
        assert all(v["device_seconds"] is None for v in st.values())  # no card
    timer = profiling.StageTimer(record=True)
    gen = prog.generator
    emb = torch.zeros(1, 64, prog.cfg.ar.dim)
    gen.generate(emb, 3, torch.zeros(1, 64, dtype=torch.long), 2, max_tokens=4, timer=timer)
    assert [s.name for s in timer.spans] == ["ar.prefill", "ar.decode"]
    assert timer.report()["ar.decode"]["tokens"] == 4
