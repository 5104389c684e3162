"""The v1 sampler's step, factored out of ``euler_solve``'s loop, the
graphed sampler around it (``models/cfm.py::EulerGraph``), and v2's
``euler_solve_multicfg`` on the same loop, on the CPU.

A CUDA graph cannot be captured here, so the graphed sampler runs with its
capture stubbed: the stub runs the first step on the static buffers and its
"replay" runs the same step on them eagerly. Everything else (the buffers, the
schedule tables, the copies, the keys, the cache, the launch counters, the
converter's choice of path) is the code the card runs. The capture and the
replays themselves are held on the card in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from seedvc_tpu_torch.core import config as pc
from seedvc_tpu_torch.models import cfm
from seedvc_tpu_torch.models.bigvgan import BigVGANConfig
from seedvc_tpu_torch.models.cfm import CFM, EulerGraph, StepGraph, euler_solve
from seedvc_tpu_torch.models.cfm_v2 import euler_solve_multicfg
from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
from seedvc_tpu_torch.ops import anti_alias, attention, launches
from seedvc_tpu_torch.pipelines import convert

torch.set_num_threads(1)

SR = 22050
WHISPER = dict(d_model=48, n_layers=1, n_heads=4, ffn_dim=96)
VOC = dict(upsample_initial_channel=128, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))


def _tiny(preset: str) -> pc.SeedVCConfig:
    """``preset`` with its DiT 64 wide (2 heads, depth 3), its WaveNet head
    32 wide (2 layers) and its regulator 64 wide over 48-wide content."""
    cfg = pc.get_preset(preset)
    mp = cfg.model_params
    mp = dataclasses.replace(
        mp, DiT=dataclasses.replace(mp.DiT, hidden_dim=64, num_heads=2, depth=3, content_dim=64),
        wavenet=dataclasses.replace(mp.wavenet, hidden_dim=32, num_layers=2),
        length_regulator=dataclasses.replace(mp.length_regulator, channels=64,
                                             in_channels=WHISPER["d_model"]))
    return dataclasses.replace(cfg, model_params=mp)


def _old_euler_solve(estimate_fn, noise, mu, x_lens, prompt, prompt_len, style, n_timesteps,
                     cfg_rate=0.7, precompute_fn=None, temperature=1.0, t_scheduler="linear"):
    """``euler_solve`` as it was before its step was factored out, on one
    device with no mesh axis."""
    if t_scheduler not in ("linear", "cosine"):
        raise ValueError(f"unknown t_scheduler {t_scheduler!r}")
    T = mu.shape[1]
    t_span = (cfm.cosine_t_span(n_timesteps) if t_scheduler == "cosine"
              else torch.linspace(0.0, 1.0, n_timesteps + 1))
    noise = noise * temperature
    in_prompt = (torch.arange(T, device=mu.device) < prompt_len)[None, :, None]
    prompt_x = torch.where(in_prompt, prompt, torch.zeros_like(prompt))
    x = torch.where(in_prompt, torch.zeros_like(noise), noise)
    use_cfg = cfg_rate > 0
    if use_cfg:
        est_prompt = torch.cat([prompt_x, torch.zeros_like(prompt_x)], 0)
        est_style = torch.cat([style, torch.zeros_like(style)], 0)
        est_mu = torch.cat([mu, torch.zeros_like(mu)], 0)
        est_lens = None if x_lens is None else torch.cat([x_lens, x_lens], 0)
    else:
        est_prompt, est_style, est_mu, est_lens = prompt_x, style, mu, x_lens
    n = est_mu.shape[0]
    est_args = ()
    if precompute_fn is not None:
        est_args = (precompute_fn(torch.zeros((n, T, noise.shape[-1]), dtype=mu.dtype),
                                  est_prompt, est_lens, est_style, est_mu),)
    for i in range(n_timesteps):
        t_cur = float(t_span[i])
        dt = float(t_span[i + 1] - t_span[i])
        xx = torch.cat([x, x], 0) if use_cfg else x
        tt = torch.full((n,), t_cur, dtype=mu.dtype)
        v = estimate_fn(xx, est_prompt, est_lens, tt, est_style, est_mu, *est_args)
        if use_cfg:
            v_cond, v_null = v.chunk(2, dim=0)
            v = (1.0 + cfg_rate) * v_cond - cfg_rate * v_null
        x = (x.float() + dt * v.float()).to(x.dtype)
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x


def _old_euler_solve_multicfg(estimate_fn, noise, mu, x_lens, prompt, prompt_len, style,
                              n_timesteps, temperature=1.0, cfg_rates=(0.5, 0.5),
                              random_voice=False, precompute_fn=None, keep=None):
    """``euler_solve_multicfg`` as it was before it ran v1's loop, on one
    device with no mesh axis: the branches combined by ``torch.tensordot``
    with the weights in the compute dtype."""
    B, T, _ = mu.shape
    z = noise * temperature
    in_prompt = (torch.arange(T, device=mu.device) < prompt_len)[None, :, None]
    prompt_x = torch.where(in_prompt, prompt, torch.zeros_like(prompt))
    x = torch.where(in_prompt, torch.zeros_like(z), z)
    branches, weights = cfm.cfg_branches(prompt_x, style, mu, cfg_rates, random_voice)
    n_br = len(branches)
    est_prompt, est_style, est_mu = (torch.cat([b[i] for b in branches], 0) for i in range(3))
    est_lens = None if x_lens is None else torch.cat([x_lens] * n_br, 0)
    w = torch.tensor(weights, dtype=mu.dtype, device=mu.device)
    est_args = ()
    if precompute_fn is not None:
        x_shape = (est_mu.shape[0], T, noise.shape[-1])
        est_args = (precompute_fn(torch.zeros(x_shape, dtype=mu.dtype, device=mu.device),
                                  est_prompt, est_lens, est_style, est_mu),)
    t_span = cfm.cosine_t_span(n_timesteps)
    for i in range(n_timesteps):
        t_cur = float(t_span[i])
        dt = float(t_span[i + 1] - t_span[i])
        xx = torch.cat([x] * n_br, 0)
        tt = torch.full((xx.shape[0],), t_cur, dtype=mu.dtype, device=mu.device)
        v = estimate_fn(xx, est_prompt, est_lens, tt, est_style, est_mu, *est_args)
        v = torch.tensordot(w, v.reshape(n_br, B, *v.shape[1:]), dims=1)
        if keep is not None:
            keep[0][i].copy_(x)
            keep[1][i].copy_(v)
        x = (x.float() + dt * v.float()).to(x.dtype)
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x


def _inputs(seed, T, dtype, lens=True, style_dim=192, content=64):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    return dict(noise=r(1, T, 80), mu=r(1, T, content),
                x_lens=torch.tensor([T - 5]) if lens else None,
                prompt=r(1, T, 80), prompt_len=T // 4, style=r(1, style_dim))


def _cfm(preset, dtype, seed=0):
    torch.manual_seed(seed)
    model = CFM(_tiny(preset).model_params).eval().to(dtype)
    # the DiT's zero-initialised output layers would make every velocity 0
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0, 0.05)
    return model


def _stub_capture(launched=None):
    """``EulerGraph._capture`` without a card: the first step run on the
    buffers, a replay that runs the step on them eagerly, ``launched`` a
    replay (none of any kernel by default)."""
    launched = launched or {"k1": 0, "k2": 0, "k3": 0}

    def capture(self, bufs, weights):
        self.run(bufs, weights)
        self.captured = getattr(self, "captured", 0) + 1
        return StepGraph(bufs, lambda: self.run(bufs, weights), launched)
    return capture


CASES = [("whisper_small_wavenet", 0.7, True, torch.float32, 1.0, "linear"),
         ("whisper_small_wavenet", 0.7, True, torch.bfloat16, 1.0, "linear"),
         ("whisper_small_wavenet", 0.0, False, torch.float32, 0.8, "cosine"),
         ("xlsr_tiny", 0.7, True, torch.bfloat16, 1.0, "linear"),
         ("xlsr_tiny", 0.5, False, torch.float32, 1.0, "cosine")]
IDS = ["wavenet-cfg-lens-f32", "wavenet-cfg-lens-bf16", "wavenet-nocfg-cosine",
       "tokens-cfg-lens-bf16", "tokens-nolens-cosine"]


@pytest.mark.parametrize("preset,cfg_rate,lens,dtype,temperature,sched", CASES, ids=IDS)
def test_factored_step_equals_the_previous_loop(preset, cfg_rate, lens, dtype, temperature,
                                                sched):
    """``euler_solve`` over :func:`cfm.euler_step` against the loop it
    replaced, bit for bit: the DiT with its WaveNet head and with time and
    style as tokens (MLP head), CFG on and off, lens set and not."""
    model = _cfm(preset, dtype)
    kw = dict(n_timesteps=4, cfg_rate=cfg_rate, precompute_fn=model.precompute_cond,
              temperature=temperature, t_scheduler=sched)
    a = _inputs(1, 40, dtype, lens)
    args = (a["noise"], a["mu"], a["x_lens"], a["prompt"], a["prompt_len"], a["style"])
    new = euler_solve(model.estimate, *args, **kw)
    old = _old_euler_solve(model.estimate, *args, **kw)
    assert new.dtype == dtype and torch.equal(new, old)
    x0 = euler_solve(model.estimate, *args, **{**kw, "n_timesteps": 0})
    assert (new.float() - x0.float()).abs().max() > 1e-2  # the steps moved the state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lens", [True, False], ids=["lens", "nolens"])
@pytest.mark.parametrize("cfg_rate", [0.7, 0.0])
def test_multicfg_at_one_rate_equals_the_v1_sampler(cfg_rate, lens, dtype):
    """``euler_solve_multicfg(cfg_rates=(r, 0))`` is ``euler_solve(cfg_rate=r)``
    on the cosine schedule, bit for bit: one loop, one combination."""
    model = _cfm("whisper_small_wavenet", dtype)
    a = _inputs(1, 40, dtype, lens)
    args = (a["noise"], a["mu"], a["x_lens"], a["prompt"], a["prompt_len"], a["style"])
    kw = dict(n_timesteps=4, precompute_fn=model.precompute_cond, temperature=0.9)
    v2 = euler_solve_multicfg(model.estimate, *args, cfg_rates=(cfg_rate, 0.0), **kw)
    v1 = euler_solve(model.estimate, *args, cfg_rate=cfg_rate, t_scheduler="cosine", **kw)
    assert v2.dtype == dtype and torch.equal(v2, v1)


# (cfg_rates, random_voice) of the five branch layouts
LAYOUTS = {"three_way": ((0.3, 0.9), False), "full_text": ((0.0, 0.9), False),
           "full_uncond": ((0.3, 0.0), False), "no_cfg": ((0.0, 0.0), False),
           "random_voice": ((0.3, 0.9), True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_multicfg_against_its_previous_loop(layout, dtype):
    """``euler_solve_multicfg`` on v1's loop against the loop it replaced,
    which combined the branches by ``tensordot`` with the weights rounded to
    the compute dtype (2.2 is 2.203125 in bf16). In f32 the two agree to 1e-6
    relative, the samples and every step's kept state and estimate. In bf16,
    at step 0 (both at the same state, on the same branch estimates v_i),
    each combination is within the roundings of its own arithmetic of the
    exact w0·v0 + w1·v1 (+ w2·v2): one bf16 unit roundoff (2^-8) of
    Σ |w_i|·|v_i| a rounding, n_br of them for the new form (each product,
    each sum), two for the old (the weights, the result); the steps after it
    start from states that differ. With one branch nothing is combined and
    the two are equal."""
    rates, rv = LAYOUTS[layout]
    model = _cfm("whisper_small_wavenet", dtype)
    a = _inputs(2, 40, dtype)
    args = (a["noise"], a["mu"], a["x_lens"], a["prompt"], a["prompt_len"], a["style"])
    steps = 4
    calls = []

    @torch.no_grad()
    def estimate(*e):
        calls.append(model.estimate(*e))
        return calls[-1]

    kw = dict(n_timesteps=steps, temperature=0.9, cfg_rates=rates, random_voice=rv,
              precompute_fn=model.precompute_cond)
    kept = [torch.empty((2, steps, *a["noise"].shape), dtype=dtype) for _ in range(2)]
    new = euler_solve_multicfg(model.estimate, *args, **kw, keep=(kept[0][0], kept[0][1]))
    old = _old_euler_solve_multicfg(estimate, *args, **kw, keep=(kept[1][0], kept[1][1]))
    assert new.dtype == dtype and (new[:, : a["prompt_len"]] == 0).all()
    _, weights = cfm.cfg_branches(a["prompt"], a["style"], a["mu"], rates, rv)
    if len(weights) == 1:
        assert torch.equal(new, old) and torch.equal(kept[0], kept[1])
        return
    if dtype == torch.float32:
        for got, want in ((new, old), (kept[0], kept[1])):
            assert (got - want).norm() <= 1e-6 * want.norm()
        return
    assert torch.equal(kept[0][0, 0], kept[1][0, 0])  # step 0's state
    v = calls[0].float().chunk(len(weights), dim=0)
    exact = sum(w * vi for w, vi in zip(weights, v))
    terms = sum(abs(w) * vi.abs() for w, vi in zip(weights, v))
    for combined, roundings in ((kept[0][1, 0], len(weights)), (kept[1][1, 0], 2)):
        assert ((combined.float() - exact).abs() <= roundings * 2.0 ** -8 * terms).all()
    assert not torch.equal(kept[0][1, 0], kept[1][1, 0])  # the weights' rounding is gone


@pytest.mark.parametrize("preset,cfg_rate,lens,dtype,temperature,sched", CASES, ids=IDS)
def test_graphed_sampler_equals_eager(monkeypatch, preset, cfg_rate, lens, dtype, temperature,
                                      sched):
    """The graphed sampler (capture stubbed: its buffers, schedule tables
    and copies, the step run on them) against ``euler_solve``, bit for bit,
    with two shapes used in turn and a new prompt length on each call."""
    monkeypatch.setattr(EulerGraph, "_capture", _stub_capture())
    model = _cfm(preset, dtype)
    sampler = EulerGraph(model.estimate, model.precompute_cond)
    for seed, T in ((1, 40), (2, 24), (3, 40), (4, 24)):
        a = _inputs(seed, T, dtype, lens)
        a["prompt_len"] = seed * 3
        args = (a["noise"], a["mu"], a["x_lens"], a["prompt"], a["prompt_len"], a["style"])
        kw = dict(n_timesteps=3, cfg_rate=cfg_rate, temperature=temperature, t_scheduler=sched)
        got = sampler(*args, **kw)
        want = euler_solve(model.estimate, *args, precompute_fn=model.precompute_cond, **kw)
        assert torch.equal(got, want)
    assert sampler.captured == 2 and len(sampler.graphs) == 2
    # the result is a copy: the next call does not overwrite it
    kept = got.clone()
    a = _inputs(9, 24, dtype, lens)
    other = sampler(a["noise"], a["mu"], a["x_lens"], a["prompt"], 5, a["style"], **kw)
    assert torch.equal(got, kept) and not torch.equal(other, kept)


def test_replays_add_the_captured_launches(monkeypatch):
    """Each replay adds what one captured step launches to the counters: a
    call of n steps replays n of them, the capturing call n - 1 after its
    first step ran eagerly (which counts its own launches: none on the CPU)."""
    monkeypatch.setattr(EulerGraph, "_capture", _stub_capture({"k1": 3, "k2": 2, "k3": 1}))
    for mod, name in ((attention, "LAUNCHES"), (attention, "DIT_ATTENTION_LAUNCHES"),
                      (anti_alias, "LAUNCHES")):
        monkeypatch.setattr(mod, name, 100)
    model = _cfm("whisper_small_wavenet", torch.float32)
    sampler = EulerGraph(model.estimate, model.precompute_cond)
    a = _inputs(1, 24, torch.float32)
    sampler(*a.values(), n_timesteps=5)
    assert launches.counts() == {"k1": 112, "k2": 108, "k3": 104}
    sampler(*a.values(), n_timesteps=2)
    assert launches.counts() == {"k1": 118, "k2": 112, "k3": 106}
    assert sampler(*a.values(), n_timesteps=0).shape == (1, 24, 80)
    assert launches.counts() == {"k1": 118, "k2": 112, "k3": 106} and sampler.captured == 1


def test_a_capture_counts_nothing_and_replays_count_their_launches(monkeypatch):
    """``ops/launches.py``: inside :func:`launches.captured` the wrappers
    count as usual; on exit the counters are back where they were and the
    yielded record holds what the captured work launched, which
    :func:`launches.replayed` adds ``n`` times. A capture that raises leaves
    the counters as they were too."""
    for mod, name, v in ((attention, "LAUNCHES", 10), (anti_alias, "LAUNCHES", 20),
                         (attention, "DIT_ATTENTION_LAUNCHES", 30)):
        monkeypatch.setattr(mod, name, v)
    with launches.captured() as launched:
        attention.LAUNCHES += 13
        anti_alias.LAUNCHES += 2
    assert launched == {"k1": 13, "k2": 2, "k3": 0}
    assert launches.counts() == {"k1": 10, "k2": 20, "k3": 30}
    launches.replayed(launched, 4)
    assert launches.counts() == {"k1": 62, "k2": 28, "k3": 30}
    launches.replayed(launched, 0)
    assert launches.counts() == {"k1": 62, "k2": 28, "k3": 30}
    with pytest.raises(RuntimeError), launches.captured():
        attention.DIT_ATTENTION_LAUNCHES += 5
        raise RuntimeError("capture failed")
    assert launches.counts() == {"k1": 62, "k2": 28, "k3": 30}


def test_graph_keys_and_the_bounded_cache(monkeypatch):
    """A context, a stack height (CFG on or off), lens present or not, a
    dtype and a ``cfg_rate`` each give another key; the prompt length and
    the step count do not. The cache keeps the most recently used graphs."""
    monkeypatch.setattr(EulerGraph, "_capture", _stub_capture())
    monkeypatch.setattr(cfm, "MAX_GRAPHS", 3)
    model = _cfm("whisper_small_wavenet", torch.float32)
    sampler = EulerGraph(model.estimate, model.precompute_cond)

    def call(T=24, cfg_rate=0.7, lens=True, prompt_len=5, steps=2):
        a = _inputs(0, T, torch.float32, lens)
        a["prompt_len"] = prompt_len
        sampler(*a.values(), n_timesteps=steps, cfg_rate=cfg_rate)
        return next(reversed(sampler.graphs))  # the key just used

    first = call()
    assert call(prompt_len=9, steps=4) == first and sampler.captured == 1
    keys = [call(T=32), call(cfg_rate=0.5), call(cfg_rate=0.0), call(lens=False)]
    assert len({first, *keys}) == 5 and sampler.captured == 5
    assert len(sampler.graphs) == 3 and list(sampler.graphs) == keys[1:]
    call(cfg_rate=0.5)  # still held: used again, no capture
    assert sampler.captured == 5 and list(sampler.graphs)[-1] == keys[1]
    call()  # evicted earlier: captured again, the oldest goes
    assert sampler.captured == 6 and list(sampler.graphs) == [keys[3], keys[1], first]
    assert cfm.graph_key({"x": torch.zeros(2, 3)}, 0.7) != cfm.graph_key(
        {"x": torch.zeros(2, 3, dtype=torch.bfloat16)}, 0.7)


@pytest.fixture(scope="module")
def converter():
    return convert.VoiceConverter(
        _tiny("whisper_small_wavenet"), whisper_cfg=WhisperEncoderConfig(**WHISPER),
        vocoder_cfg=BigVGANConfig(**VOC), prompt_cap_frames=64, context_frames=192,
        device="cpu", seed=5)


def _audio(n_frames, f0, seed):
    n = n_frames * 256
    t = np.arange(n) / SR
    noise = np.random.default_rng(seed).standard_normal(n)
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * noise).astype(np.float32)


def _convert(vc, steps=3):
    _, wave, stats = vc.convert(_audio(200, 150.0, 1), SR, _audio(50, 230.0, 2), SR,
                                diffusion_steps=steps, seed=7)
    return wave, stats["stages"]["sample"], stats["chunks"]


def test_converter_samples_eagerly_on_the_cpu(converter, monkeypatch):
    """On the CPU the converter's sampler is the eager loop: ``graphed_steps``
    is 0 beside ``steps``."""
    monkeypatch.setattr(EulerGraph, "__call__", lambda *a, **k: pytest.fail("graphed"))
    assert converter._use_graph is False and not converter._graphed()
    wave, sample, chunks = _convert(converter)
    assert chunks == 2 and sample["steps"] == 6 and sample["graphed_steps"] == 0
    assert np.abs(wave).max() > 0


@pytest.mark.parametrize("axis", ["cfg_shard_axis", "seq_shard_axis", "capturing"])
def test_converter_keeps_the_eager_loop_where_a_step_cannot_be_graphed(converter, monkeypatch,
                                                                       axis):
    """With the graph on (as on cuda), a shard axis (collectives in the step) or
    a capture underway (the stream's block program) keeps the eager loop,
    which gets the axis; ``graphed_steps`` reads 0."""
    seen = []

    def solve(*a, **k):
        seen.append((k["shard_axis"], k["seq_shard_axis"]))
        return euler_solve(*a, **{**k, "shard_axis": None, "seq_shard_axis": None})

    monkeypatch.setattr(convert, "euler_solve", solve)
    monkeypatch.setattr(EulerGraph, "__call__", lambda *a, **k: pytest.fail("graphed"))
    monkeypatch.setattr(converter, "_use_graph", True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: axis == "capturing")
    if axis != "capturing":
        monkeypatch.setattr(converter, axis, "model")
    _, sample, chunks = _convert(converter)
    assert sample["steps"] == 6 and sample["graphed_steps"] == 0
    want = {"cfg_shard_axis": ("model", None), "seq_shard_axis": (None, "model"),
            "capturing": (None, None)}[axis]
    assert seen == [want] * chunks


def test_converter_graphed_conversion_equals_eager(converter, monkeypatch):
    """The converter's graphed path (capture stubbed) gives the eager
    conversion's wave bit for bit, and counts every step as graphed."""
    eager, sample, _ = _convert(converter)
    monkeypatch.setattr(EulerGraph, "_capture", _stub_capture())
    monkeypatch.setattr(converter, "_use_graph", True)
    monkeypatch.setattr(converter, "sampler", EulerGraph(converter.vc.estimate,
                                                         converter.vc.precompute_cond))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    graphed, g_sample, chunks = _convert(converter)
    assert np.array_equal(graphed, eager) and np.abs(eager).max() > 0
    assert g_sample["steps"] == g_sample["graphed_steps"] == sample["steps"] == 3 * chunks
    assert converter.sampler.captured == 1  # both chunks at one context
