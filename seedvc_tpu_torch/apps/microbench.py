"""Per-component microbenchmarks of the port, with achieved-rate accounting
(port of ``seedvc_tpu/apps/microbench.py``).

Times the hot components of the 98M ``whisper_small_wavenet`` sampler at its
production shape (B = 2 CFG stack, T = 2560, bf16 activations), the BigVGAN
vocoder, the batched 25-step sampler, the v2 AR decode and the v1 and v2
fine-tuning steps, and prints one JSON row per component: ``name``, ``ms``
and, where the JAX package gives them, ``tflops_per_s`` / ``gb_per_s`` /
``audio_s_per_s`` from the same FLOP formulas; plus ``device`` (the card's
name) and ``calls`` (how many times the component ran, warm-up included, so
a caller can check kernel launch counts).

    python -m seedvc_tpu_torch.apps.microbench              # every ported component
    python -m seedvc_tpu_torch.apps.microbench --only dit,attention

Timing: CUDA events around ``inner`` eager calls, best of ``iters``, after
one warm-up call. Every function takes the JAX package's size arguments plus
``device`` (default ``"cuda"``; raises without a card) and, where a model is
built, ``cfg`` (default the preset), so tests can run them tiny on the CPU,
where the host clock stands in for the events. Weights and inputs are random
from fixed seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from seedvc_tpu_torch.core.profiling import cuda_time_ms

PRESET = "whisper_small_wavenet"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("microbench: no CUDA device; pass device='cpu' to run the "
                           "plain twins on the CPU")
    return dev


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _build(make, dev: torch.device, dtype: torch.dtype, seed: int = 0):
    """A module from ``make()`` with weights drawn from ``seed``, frozen, on
    ``dev`` in ``dtype``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make()
    return module.requires_grad_(False).eval().to(dev, dtype)


def _randn(gen: torch.Generator, shape, dev, dtype, scale: float = 1.0) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)


def _flash_model_params(cfg):
    """The preset's model params with flash attention on, as the JAX
    microbench forces it."""
    if cfg is None:
        from seedvc_tpu_torch.core.config import get_preset

        cfg = get_preset(PRESET)
    mp = cfg.model_params
    return cfg, dataclasses.replace(mp, DiT=dataclasses.replace(mp.DiT, use_flash_attention=True))


def timeit(fn, dev: torch.device, iters: int = 3, inner: int = 20) -> tuple[float, int]:
    """(best seconds per call, number of calls made). One warm-up call, then
    ``iters`` windows of ``inner`` calls each."""
    fn()
    best = math.inf
    for _ in range(iters):
        if dev.type == "cuda":
            best = min(best, cuda_time_ms(fn, iters=inner, warmup=0) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            best = min(best, (time.perf_counter() - t0) / inner)
    return best, 1 + iters * inner


def report(name: str, seconds: float, dev: torch.device, calls: int,
           flops: float | None = None, bytes_moved: float | None = None,
           audio_seconds: float | None = None, **extra) -> dict:
    row = {"name": name, "ms": seconds * 1e3, **extra}
    if flops:
        row["tflops_per_s"] = flops / seconds / 1e12
    if bytes_moved:
        row["gb_per_s"] = bytes_moved / seconds / 1e9
    if audio_seconds:
        row["audio_s_per_s"] = audio_seconds / seconds
    row.update(device=_device_name(dev), calls=calls)
    print(json.dumps(row), flush=True)
    return row


@torch.no_grad()
def bench_attention(B=2, T=2560, H=8, hd=64, flash=True, device="cuda"):
    """One attention layer without ``rope_full``: K3 with ``flash``, the
    einsum path without."""
    from seedvc_tpu_torch.nn.layers import Attention, rope_cache

    dev = _device(device)
    d = H * hd
    attn = _build(lambda: Attention(d, H, use_flash=flash), dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (B, T, d), dev, torch.bfloat16)
    freqs = torch.from_numpy(rope_cache(T, hd)).to(dev)
    dt, calls = timeit(lambda: attn(x, freqs, None), dev)
    flops = 2 * B * (4 * T * d * d          # qkv+o projections
                     + 2 * T * T * d)       # qk + av
    return report(f"attention(flash={flash}) B{B} T{T} H{H} hd{hd}", dt, dev, calls, flops)


@torch.no_grad()
def bench_ffn(B=2, T=2560, d=512, device="cuda"):
    from seedvc_tpu_torch.nn.layers import FeedForward, ffn_intermediate_size

    dev = _device(device)
    inter = ffn_intermediate_size(d)
    ffn = _build(lambda: FeedForward(d, inter), dev, torch.bfloat16)
    x = _randn(torch.Generator(device=dev).manual_seed(0), (B, T, d), dev, torch.bfloat16)
    dt, calls = timeit(lambda: ffn(x), dev)
    return report(f"swiglu_ffn B{B} T{T} d{d} inter{inter}", dt, dev, calls,
                  2 * B * T * 3 * d * inter)


@torch.no_grad()
def bench_int8_matmul(M=5120, K=512, N=1536, device="cuda"):
    """Two chained products at the FFN-w1 shape of the CFG-stacked sampler
    (M = 2*2560 tokens): bf16, against int8 (``torch._int_mm``) with
    per-tensor weight scales and per-row dynamic activation scales, which
    is what an int8 trunk path would pay."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (M, K), dev, torch.bfloat16)
    w1 = _randn(gen, (K, N), dev, torch.bfloat16, 1 / 16)
    w2 = _randn(gen, (N, K), dev, torch.bfloat16, 1 / 16)

    def q8(w):  # per-tensor weight quantisation (probe only)
        s = w.float().abs().max().clamp_min(1e-8) / 127.0
        return torch.round(w.float() / s).to(torch.int8), s

    def qa(a):  # per-row dynamic activation quantisation; zero rows stay finite
        s = a.float().abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0
        return torch.round(a.float() / s).to(torch.int8), s

    (w1q, s1), (w2q, s2) = q8(w1), q8(w2)

    def int8_dynamic():
        x8, sx = qa(x)
        h = torch._int_mm(x8, w1q).float() * (sx * s1)
        h8, sh = qa(h)
        return (torch._int_mm(h8, w2q).float() * (sh * s2)).to(torch.bfloat16)

    flops = 2 * M * K * N * 2  # w1 + w2 round trip
    rows = []
    for name, fn in ((f"matmul2_bf16 {M}x{K}x{N}", lambda: (x @ w1) @ w2),
                     (f"matmul2_int8_dynamic {M}x{K}x{N}", int8_dynamic)):
        dt, calls = timeit(fn, dev)
        rows.append(report(name, dt, dev, calls, flops))
    return rows


@torch.no_grad()
def bench_wavenet(B=2, T=2560, device="cuda", cfg=None):
    from seedvc_tpu_torch.nn.wavenet import WaveNet

    dev = _device(device)
    cfg, mp = _flash_model_params(cfg)
    wn = mp.wavenet
    net = _build(lambda: WaveNet(wn.hidden_dim, wn.kernel_size, wn.dilation_rate,
                                 wn.num_layers, gin_channels=wn.hidden_dim),
                 dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (B, T, wn.hidden_dim), dev, torch.bfloat16)
    mask = torch.ones((B, T, 1), dtype=torch.bfloat16, device=dev)
    g = _randn(gen, (B, 1, wn.hidden_dim), dev, torch.bfloat16)
    dt, calls = timeit(lambda: net(x, mask, g=g), dev)
    d = wn.hidden_dim
    flops = 2 * B * T * wn.num_layers * (d * 2 * d * wn.kernel_size  # in gated conv
                                         + d * 2 * d)                # res/skip 1x1
    return report(f"wavenet_postnet B{B} T{T} d{d} L{wn.num_layers}", dt, dev, calls, flops)


@torch.no_grad()
def bench_dit_step(B=1, T=2560, device="cuda", cfg=None):
    """One estimator call at the CFG-stacked shape (2B, T), bf16, every key
    valid: one K1 launch per DiT layer."""
    from seedvc_tpu_torch.models.cfm import CFM

    dev = _device(device)
    cfg, mp = _flash_model_params(cfg)
    cfm = _build(lambda: CFM(mp), dev, torch.bfloat16)
    C, D = mp.DiT.in_channels, mp.DiT.content_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, (2 * B, T, C), dev, torch.bfloat16)
    p = _randn(gen, (2 * B, T, C), dev, torch.bfloat16)
    lens = torch.full((2 * B,), T, dtype=torch.int32, device=dev)
    t = torch.rand((2 * B,), generator=gen, device=dev)
    style = _randn(gen, (2 * B, mp.style_encoder.dim), dev, torch.bfloat16)
    cond = _randn(gen, (2 * B, T, D), dev, torch.bfloat16)
    dt, calls = timeit(lambda: cfm.estimate(x, p, lens, t, style, cond), dev)
    n_params = sum(w.numel() for w in cfm.parameters())
    d_model = mp.DiT.hidden_dim
    flops = (2 * n_params * 2 * B * T                             # matmul 2*P*tokens
             + 2 * 2 * B * mp.DiT.depth * 2 * T * T * d_model)    # attention
    return report(f"dit_estimator_cfg_call B{2 * B} T{T} ({n_params / 1e6:.0f}M)",
                  dt, dev, calls, flops)


@torch.no_grad()
def bench_serving(B=4, T=2560, n_steps=25, device="cuda", cfg=None):
    """Batched serving: the full CFG Euler sampler for B utterances at once
    (the estimator sees 2B), aggregate audio-s/s over the generated region.
    The prompt is 3 s; noise comes from a seeded ``torch.Generator``."""
    from seedvc_tpu_torch.models.cfm import CFM, euler_solve

    dev = _device(device)
    cfg, mp = _flash_model_params(cfg)
    sr = cfg.preprocess_params.sr
    hop = cfg.preprocess_params.spect_params.hop_length
    prompt_len = int(sr / hop * 3)
    C, D = mp.DiT.in_channels, mp.DiT.content_dim
    cfm = _build(lambda: CFM(mp), dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.zeros((B, T, C), dtype=torch.bfloat16, device=dev)
    style = _randn(gen, (B, mp.style_encoder.dim), dev, torch.bfloat16)
    cond = _randn(gen, (B, T, D), dev, torch.bfloat16)

    def sample():
        noise = _randn(gen, (B, T, C), dev, torch.bfloat16)
        return euler_solve(cfm.estimate, noise, cond, None, x0, prompt_len, style,
                           n_timesteps=n_steps, cfg_rate=0.7, precompute_fn=cfm.precompute_cond)

    dt, calls = timeit(sample, dev, iters=3, inner=1)
    return report(f"serving B{B} T{T} {n_steps}-step", dt, dev, calls,
                  audio_seconds=B * (T - prompt_len) * hop / sr)


@torch.no_grad()
def bench_vocoder(B=1, T=512, device="cuda", cfg=None):
    """BigVGAN 22 kHz 80-band (``cfg``, a ``BigVGANConfig``), f32 with TF32
    off: every activation is one anti-aliased snake (K2) launch."""
    from seedvc_tpu_torch.models.bigvgan import BIGVGAN_22K_80, BigVGAN

    dev = _device(device)
    voc_cfg = cfg or BIGVGAN_22K_80
    voc = _build(lambda: BigVGAN(voc_cfg), dev, torch.float32)
    mel = _randn(torch.Generator(device=dev).manual_seed(0), (B, T, voc_cfg.num_mels),
                 dev, torch.float32)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dt, calls = timeit(lambda: voc(mel), dev, iters=3, inner=5)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return report(f"bigvgan B{B} T{T}", dt, dev, calls,
                  audio_seconds=B * T * voc_cfg.total_upsample / 22050)


@torch.no_grad()
def bench_ar_decode(B=1, n_tokens=128, max_seq=4096, device="cuda", cfg=None):
    """Incremental AR decode, ms a token, at the v2 model's size (``cfg``,
    default ``ARConfig()``: 768 wide, 12 layers, 2 KV heads) with a
    ``max_seq`` cache, bf16 on cuda (f32 on the CPU): ``n_tokens`` decode
    steps from position 0, each feeding its argmax back (no sampling), as
    the JAX package's component. On cuda the step is captured as one CUDA
    graph and the replays are timed (``ms_per_token``); the same step run
    eagerly is timed beside it (``eager_ms_per_token``). ``gb_per_s`` counts
    the weights and the whole KV cache read once a token."""
    from seedvc_tpu_torch.models.ar import ARConfig, ARTransformer
    from seedvc_tpu_torch.ops import ar_decode

    dev = _device(device)
    cfg = dataclasses.replace(cfg or ARConfig(), max_seq_len=max_seq)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = _build(lambda: ARTransformer(cfg), dev, dtype)
    kc, vc = model.new_caches(B, dev, dtype)
    scratch = ar_decode.new_scratch(B, cfg, dev, dtype) if dev.type == "cuda" else None
    pos = torch.zeros((), dtype=torch.long, device=dev)
    tok = torch.zeros(B, dtype=torch.long, device=dev)

    def step():
        logits = model.decode_step(model.embed_tokens(tok[:, None]), pos.expand(B), pos, kc, vc,
                                   scratch=scratch)
        tok.copy_(torch.argmax(logits, dim=-1))
        pos.add_(1)

    def decode(one):
        pos.zero_()
        tok.zero_()
        for _ in range(n_tokens):
            one()

    graph = None
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
    eager, calls = timeit(lambda: decode(step), dev, iters=2, inner=1)
    per_token, more = ((eager, 0) if graph is None
                       else timeit(lambda: decode(graph.replay), dev, iters=3, inner=1))
    per_token, eager = per_token / n_tokens, eager / n_tokens
    n_params = sum(w.numel() for w in model.parameters())
    kv_bytes = kc.numel() * kc.element_size() * 2
    row = {"name": f"ar_decode B{B} seq{max_seq} ({n_params / 1e6:.0f}M params)",
           "ms_per_token": per_token * 1e3, "tokens_per_s": B / per_token,
           "eager_ms_per_token": eager * 1e3, "graph": graph is not None,
           "gb_per_s": (n_params * model.output.weight.element_size() + kv_bytes)
           / per_token / 1e9,
           "device": _device_name(dev), "calls": (calls + more) * n_tokens}
    print(json.dumps(row), flush=True)
    return row


def bench_train_step(B=4, T=512, Ts=256, compute_dtype=None, device="cuda", cfg=None):
    """The v1 train step (98M DiT + WaveNet head, regulator; forward, backward
    through K1ᵇ, the AdamW update) at a fine-tuning shape, with the frozen
    encoders' features given as zeros, as the JAX component gives them:
    steps/s and TFLOP/s from the JAX package's 3·2·params·B·T estimate. As
    the JAX component, the step is the sharded one on a 1 x 1 mesh."""
    from seedvc_tpu_torch.models.vc import VCModel
    from seedvc_tpu_torch.parallel.mesh import make_mesh
    from seedvc_tpu_torch.train.optim import make_optimizer
    from seedvc_tpu_torch.train.step import init_state, make_sharded_train_step, shard_state

    dev = _device(device)
    cfg, mp = _flash_model_params(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = VCModel(mp)
    model.to(dev)
    optimizer = make_optimizer(1e-4)
    mesh = make_mesh(n_data=1, n_model=1, device_type=dev.type)
    state = shard_state(init_state(model, optimizer), mesh, model=model)
    step = make_sharded_train_step(model, optimizer, mesh, compute_dtype=compute_dtype)
    d_in = mp.length_regulator.in_channels
    batch = {"s_alt": torch.zeros((B, Ts, d_in), device=dev),
             "s_ori": torch.zeros((B, Ts, d_in), device=dev),
             "mels": torch.zeros((B, T, mp.DiT.in_channels), device=dev),
             "mel_lens": torch.full((B,), T, dtype=torch.int32, device=dev),
             "style": torch.zeros((B, mp.style_encoder.dim), device=dev)}
    holder = [state]

    def one():
        holder[0], metrics = step(holder[0], batch, (1, holder[0].step))
        return metrics

    dt, calls = timeit(one, dev, iters=3, inner=2)
    n_params = sum(w.numel() for w in model.parameters())
    tag = "" if compute_dtype is None else "_bf16"
    row = report(f"train_step{tag} B{B} T{T} ({n_params / 1e6:.0f}M)", dt, dev, calls,
                 3 * 2 * n_params * B * T, steps_per_s=1.0 / dt)
    return row


def bench_train_onfly(B=4, steps=12, prefetch=2, device="cuda", cfg=None, whisper_cfg=None):
    """On-the-fly v1 fine-tuning through ``Trainer.train``: the frozen
    encoders (Whisper's 30 s window, the mel, CAMPPlus) run every step, with
    the prefetch worker (``prefetch=2``) or synchronously (0). 2B clips of
    5.7-5.86 s in one 128-frame mel bucket (T = 512); 3 warm steps fill the
    feature cache, then ``steps`` are timed by the host clock. TFLOP/s counts
    the train step's 3·2·params·B·T alone."""
    import os
    import tempfile

    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.core.config import get_preset
    from seedvc_tpu_torch.models.whisper import WHISPER_SMALL
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = _device(device)
    cfg = cfg or get_preset(PRESET)
    sr = cfg.preprocess_params.sr
    hop = cfg.preprocess_params.spect_params.hop_length
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="onfly_") as tmp:
        for i in range(2 * B):
            t = np.arange(int((5.7 + 0.02 * i) * sr)) / sr
            w = 0.3 * np.sin(2 * np.pi * 150 * t) + 0.01 * rng.standard_normal(len(t))
            save_wav(os.path.join(tmp, f"c{i}.wav"), w.astype(np.float32), sr)
        warm = 3
        tcfg = TrainerConfig(run_dir="", batch_size=B, epochs=10 ** 6, max_steps=warm,
                             log_interval=10 ** 9, save_interval=10 ** 9, mel_bucket=128,
                             prefetch=prefetch)
        trainer = Trainer(cfg, tcfg, whisper_cfg=whisper_cfg or WHISPER_SMALL, device=dev)
        ds = FTDataset(tmp, sr, batch_size=B)
        trainer.train(ds)
        trainer.tcfg = dataclasses.replace(tcfg, max_steps=warm + steps)
        _sync(dev)
        t0 = time.perf_counter()
        final = trainer.train(ds)
        _sync(dev)
        dt = (time.perf_counter() - t0) / (final - warm)
    n_params = sum(w.numel() for w in trainer.model.parameters())
    T = -(-int(5.86 * sr) // hop // 128) * 128
    return report(f"train_onfly prefetch{prefetch} B{B} ({steps} steps)", dt, dev,
                  final, 3 * 2 * n_params * B * T, steps_per_s=1.0 / dt)


def bench_train_onfly_v2(B=2, steps=8, device="cuda", cfg=None):
    """On-the-fly v2 fine-tuning through ``TrainerV2.train`` (HuBERT-large,
    both ASTRAL quantizers and CAMPPlus every step, then the DiTV2 + AR
    step), from one trainer: 3 warm steps, then ``steps`` with the prefetch
    worker (depth 2) and ``steps`` synchronously (depth 0), each timed by the
    host clock. 2B clips of 4.2-4.34 s: one 5 s SSL bucket and one 128-frame
    mel bucket (T = 384); token buckets of 256 hold every count. Two rows;
    ``calls`` is the steps up to the end of each window (warm-up included in
    the first), so the rows' calls sum to the steps run."""
    import os
    import tempfile

    from seedvc_tpu_torch.apps.audio_io import save_wav
    from seedvc_tpu_torch.pipelines.convert_v2 import V2Config
    from seedvc_tpu_torch.train.dataset import FTDataset
    from seedvc_tpu_torch.train.trainer_v2 import TrainerV2, TrainerV2Config

    dev = _device(device)
    cfg = cfg or V2Config()
    rng = np.random.default_rng(0)
    rows = []
    with tempfile.TemporaryDirectory(prefix="onfly_v2_") as tmp:
        for i in range(2 * B):
            t = np.arange(int((4.2 + 0.02 * i) * cfg.sr)) / cfg.sr
            w = 0.3 * np.sin(2 * np.pi * (150 + 7 * i) * t) + 0.01 * rng.standard_normal(len(t))
            save_wav(os.path.join(tmp, f"c{i}.wav"), w.astype(np.float32), cfg.sr)
        warm = 3
        tcfg = TrainerV2Config(batch_size=B, epochs=10 ** 6, max_steps=warm,
                               log_interval=10 ** 9, save_interval=10 ** 9, prefetch=2,
                               token_bucket=256)
        trainer = TrainerV2(cfg, tcfg, device=dev)
        ds = FTDataset(tmp, cfg.sr, batch_size=B)
        trainer.train(ds)
        done = warm
        for tag, depth in (("prefetch", 2), ("sync", 0)):
            trainer.tcfg = dataclasses.replace(tcfg, prefetch=depth, max_steps=done + steps)
            _sync(dev)
            t0 = time.perf_counter()
            final = trainer.train(ds)
            _sync(dev)
            dt = (time.perf_counter() - t0) / (final - done)
            rows.append(report(f"train_onfly_v2_{tag} B{B} ({steps} steps)", dt, dev,
                               final if tag == "prefetch" else final - done,
                               steps_per_s=1.0 / dt))
            done = final
    return rows


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


ALL = {
    "attention": bench_attention,
    "attention_xla": lambda **kw: bench_attention(flash=False, **kw),
    "ffn": bench_ffn,
    "int8_matmul": bench_int8_matmul,
    "wavenet": bench_wavenet,
    "dit": bench_dit_step,
    "vocoder": bench_vocoder,
    "serving": bench_serving,
    "serving_b1": lambda **kw: bench_serving(B=1, **kw),
    "serving_b2": lambda **kw: bench_serving(B=2, **kw),
    "ar_decode": bench_ar_decode,
    "ar_decode_b4": lambda **kw: bench_ar_decode(B=4, **kw),
    "train_step": bench_train_step,
    "train_step_bf16": lambda **kw: bench_train_step(compute_dtype=torch.bfloat16, **kw),
    "train_onfly": bench_train_onfly,
    "train_onfly_sync": lambda **kw: bench_train_onfly(prefetch=0, **kw),
    "train_onfly_v2": bench_train_onfly_v2,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of: " + ",".join(ALL))
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(ALL)
    unknown = [n for n in names if n not in ALL]
    if unknown:
        ap.error(f"unknown components {unknown}")
    dev = _device("cuda")
    print(f"device: {_device_name(dev)}", flush=True)
    return {name: ALL[name]() for name in names}


if __name__ == "__main__":
    main()
