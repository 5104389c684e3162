"""The v1 converter's cells (offline; a later web cell can share it): its
inputs made from the seed, its warm-up, the operations of a conversion, and the
comparison of its outputs with the frozen reference.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from vcbench import control, traffic as T
from vcbench.audio import speech_like

OVERLAP_FRAMES = 16


@dataclass
class Inputs:
    """One cycle slot's audio (the same for every request of the slot)."""
    source: np.ndarray
    reference: np.ndarray


@dataclass
class Done:
    """A request's outcome: when it started and finished (host seconds
    from the window's opening), its wave and its stages' seconds."""
    req: T.Request
    start: float
    end: float = math.inf
    wave: np.ndarray | None = None
    error: str | None = None
    stages: dict | None = None


def make_inputs(tr: dict, seed: int) -> dict[int, Inputs]:
    sr = int(tr["sample_rate"])
    return {s["slot"]: Inputs(
        speech_like(s["source_seconds"], sr, T.rng(seed, 2, s["slot"])),
        speech_like(s["reference_seconds"], sr, T.rng(seed, 3, s["slot"])))
        for s in T.cycle(tr)}


def noise_fn(seed: int, index: int, device):
    """The request's initial noise, chunk after chunk, from a generator on
    the device seeded by (seed, request index)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + index) % (2 ** 63))
    return lambda shape: torch.randn(shape, generator=g, device=device)


def convert_kwargs(tr: dict, req: T.Request, seed: int, device) -> dict:
    return dict(diffusion_steps=req.steps, cfg_rate=float(tr.get("cfg_rate", 0.7)),
                length_adjust=float(tr.get("length_adjust", 1.0)),
                noise_fn=noise_fn(seed, req.index, device))


def lengths(cfg: dict, tr: dict, req: T.Request, inp: Inputs) -> dict:
    """The conversion's lengths as the converter derives them (resampling
    by ``resample_poly``'s ceil(n up / down); the prompt capped)."""
    pre = cfg["preset"]["preprocess_params"]
    sr, hop = pre["sr"], pre["spect_params"]["hop_length"]
    sr_in = int(tr["sample_rate"])

    def rs(n, new):
        g = math.gcd(sr_in, new)
        return n if new == sr_in else -(-n * (new // g) // (sr_in // g))

    conv = cfg["converter"]
    context = conv["context_frames"] or max(int(sr // hop * 30) // 512, 1) * 512
    cap = conv["prompt_cap_frames"]
    src = rs(len(inp.source), sr)
    ref = rs(len(inp.reference), sr)
    src16 = rs(len(inp.source), 16000)
    ref = min(ref, cap * hop)
    ref16 = min(rs(len(inp.reference), 16000), int(ref / sr * 16000))
    target_len = int(src // hop * float(tr.get("length_adjust", 1.0)))
    p_len = ref // hop
    return dict(sr=sr, hop=hop, context=context, cap=cap, src16=src16, ref16=ref16,
                target_len=target_len, p_len=p_len)


def plan(cfg: dict, L: dict) -> tuple[tuple, list[int]]:
    """(prompt_cap_b, context, W) and each chunk's valid frames w."""
    from vcbench.ref.pipelines.convert import plan_chunks
    cap_b, context, W = plan_chunks(L["target_len"], L["p_len"], L["context"], L["cap"])
    ws, processed = [], 0
    while processed < L["target_len"]:
        w = min(W, L["target_len"] - processed)
        is_last = processed + W >= L["target_len"]
        ws.append(w)
        processed += w if is_last else (w - OVERLAP_FRAMES)
    return (cap_b, context, W), ws


def conversion_ops(counter, cfg: dict, L: dict, steps: int) -> dict:
    """Operations of one conversion by precision: ``low`` (the bf16 parts:
    content encoder, DiT) and ``f32`` (style encoder, regulator, vocoder)."""
    (cap_b, context, W), ws = plan(cfg, L)

    def windows(n16):
        return 1 if n16 <= 30 * 16000 else 1 + math.ceil((n16 - 30 * 16000) / (25 * 16000))

    low = (windows(L["src16"]) + windows(L["ref16"])) * counter.whisper_window()
    bucket = -(-max(L["ref16"], 1600) // 16000) * 16000
    f32 = counter.style((bucket - 400) // 160 + 1)
    for n16, out_len in ((L["src16"], L["target_len"]), (L["ref16"], L["p_len"])):
        s_T = n16 // 320 + 1
        f32 += counter.regulate(-(-max(s_T, 1) // 64) * 64, -(-out_len // 256) * 256)
    for w in ws:
        dense, attn = counter.sampler(context, steps, L["p_len"] + w)
        low += dense + attn
        f32 += counter.vocode(W)
    return {"low": low, "f32": f32, "chunks": len(ws), "context": context,
            "n_valid": [L["p_len"] + w for w in ws]}


def warm(conv, cfg: dict, tr: dict, inputs: dict[int, Inputs], seed: int, device) -> int:
    """One two-step conversion of one slot per distinct plan of the cycle:
    every shape the window meets, built and cached before it opens."""
    seen = set()
    for s in T.cycle(tr):
        inp = inputs[s["slot"]]
        p, _ = plan(cfg, lengths(cfg, tr, T.Request(0, s["slot"], 0, 0, 2), inp))
        if p in seen:
            continue
        seen.add(p)
        req = T.Request(index=-1 - len(seen), slot=s["slot"], source_seconds=0,
                        reference_seconds=0, steps=2)
        conv.convert(inp.source, int(tr["sample_rate"]), inp.reference,
                     int(tr["sample_rate"]), **convert_kwargs(tr, req, seed, device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return len(seen)


def sample(done: list[Done], k: int, seed: int) -> list[Done]:
    """``k`` finished requests drawn from the seed, the longest among them."""
    finished = [d for d in done if d.wave is not None]
    if not finished:
        return []
    longest = max(finished, key=lambda d: len(d.wave))
    rest = [d for d in finished if d is not longest]
    g = T.rng(seed, 4)
    picks = [rest[i] for i in g.permutation(len(rest))[: max(k - 1, 0)]]
    return [longest, *picks]


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| over the common length (a length mismatch is
    itself a failure: returns inf)."""
    if len(a) != len(b):
        return math.inf
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a64 - b64) / max(np.linalg.norm(b64), 1e-30))


def reference_waves(cfg: dict, tr: dict, inputs, picks: list[Done], seed: int, device,
                    builder, quantised: bool = False) -> list[np.ndarray]:
    """The frozen reference's waves for the picked requests (same weights,
    audio and noise); ``quantised``: its bf16 parts at fp8 (the control)."""
    ref = builder.reference(cfg, device)
    builder.fill(ref, cfg, seed, device)
    hooks = control.fp8(ref.whisper, ref.vc.cfm.estimator) if quantised else []
    sr_in = int(tr["sample_rate"])
    out = []
    from vcbench.ref.pipelines import convert as ref_convert
    sampler = ref_convert.euler_solve
    if quantised:
        ref_convert.euler_solve = control.euler_solve_fp8
    try:
        with torch.no_grad():
            for d in picks:
                inp = inputs[d.req.slot]
                _, wave, _ = ref.convert(inp.source, sr_in, inp.reference, sr_in,
                                         **convert_kwargs(tr, d.req, seed, device))
                out.append(wave)
    finally:
        ref_convert.euler_solve = sampler
        for h in hooks:
            h.remove()
    del ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def check(run, done: list[Done], inputs, builder) -> dict:
    """Compare the sampled requests' waves with the reference's; returns
    {check name: (value, limit)}."""
    tr, cfg = run.traffic, run.config
    spec = tr["check"]
    picks = sample(done, int(spec["requests"]), run.seed)
    t0 = time.perf_counter()
    refs = reference_waves(cfg, tr, inputs, picks, run.seed, run.device, builder)
    run.log(f"reference over {len(picks)} requests "
            f"({sum(len(r) for r in refs) / run.config['preset']['preprocess_params']['sr']:.1f}"
            f" s of audio) in {time.perf_counter() - t0:.1f} s")
    errs = [rel_err(d.wave, r) for d, r in zip(picks, refs)]
    value = max(errs) if errs else math.inf
    return {"wave_rel_err": (value, float(spec["limit"]["wave_rel_err"]))}
