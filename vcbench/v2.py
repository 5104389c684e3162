"""The v2 converter's cell: its requests' arguments, its warm-up, what a
finished request keeps for the readers and the check, the operations of a
conversion, and the comparison with the frozen reference.

Every request runs with ``keep_intermediates``: the numbers compared are
those the timed conversion itself computed, brought to the host once it has
returned. Each stage is held against the reference on the program's own
inputs to it, so that an error is the stage's own and not one amplified by
the stages before (BSQ codes and sampled tokens flip at near-ties, and the
sampler's ODE at random weights multiplies rounding):

- ``content_feat_rel_err``: HuBERT's features of source and reference
  (pooled, every frame of the 5 s bucket) against the reference's, which
  resamples, cuts and buckets the same audio itself;
- ``quant_rel_err``: both quantizers' normalised projections (whose signs
  are the tokens) against the reference quantizers' on the program's
  features;
- ``ar_logit_rel_err``: the decode's f32 logits against the full forward
  teacher-forced on the program's conditions, prompt and decoded tokens,
  pooled over every decoded position of the checked requests;
- ``dit_est_rel_err``: the combined 3-branch estimate of each Euler step
  before ``EARLY_T`` over the chunk's generated frames against the
  reference's at the program's own state, pooled over those steps and the
  chunks;
- ``wave_rel_err``: the reference's regulator, sampler and vocoder run on
  the program's wide tokens with the same noise, against the program's
  wave: the whole chain, for gross faults (the ODE amplifies rounding).

Each but the logits is the worst of the checked requests.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from vcbench import traffic as T, v1
CHECKED = ("ar_logit_rel_err", "dit_est_rel_err", "wave_rel_err", "content_feat_rel_err",
           "quant_rel_err")
SIDES = ("source", "reference")
# The sampler's estimates are compared at the steps whose t lies below this
# (7 of 30). At random weights the DiT grows ill-conditioned along its own
# trajectory: bf16 moves its estimate 3-7% at these steps and 10-30% from t
# near 0.15 on, where fp8 moves it 25-55% throughout (13 layers, on the CPU).
EARLY_T = 0.05


@dataclass
class Done(v1.Done):
    """A v2 request's outcome; ``info``: its tokens, the AR's rows and the
    lengths the readers count operations from; ``kept``: the conversion's
    intermediates on the host (:func:`to_host`); ``keep_s``: the seconds
    bringing them there took."""
    info: dict | None = None
    kept: dict | None = None
    keep_s: float = 0.0


def draws_fn(seed: int, index: int, device):
    """The AR's exponential draws of request ``index``, from a generator on
    the device seeded by (seed, index). The EOS column (the vocabulary's
    last) is infinite, so no row draws EOS and each decodes to its cap (every
    request caps its rows at their source spans): a trained model stops near
    its source's length, random weights stop at random, and a run's audio
    with them."""
    def draws(shape):
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) * 1_000_033 + 7 * index + 1) % (2 ** 63))
        q = torch.empty(shape, device=device).exponential_(generator=g)
        q.clamp_min_(torch.finfo(torch.float32).tiny)
        q[..., -1] = math.inf
        return q
    return draws


def convert_kwargs(tr: dict, req: T.Request, seed: int, device) -> dict:
    return dict(diffusion_steps=req.steps,
                intelligibility_cfg_rate=float(tr["intelligibility_cfg_rate"]),
                similarity_cfg_rate=float(tr["similarity_cfg_rate"]),
                top_p=float(tr["top_p"]), temperature=float(tr["temperature"]),
                repetition_penalty=float(tr["repetition_penalty"]),
                length_adjust=float(tr.get("length_adjust", 1.0)),
                convert_style=bool(tr["convert_style"]), cap_to_source=True,
                draws_fn=draws_fn(seed, req.index, device),
                noise_fn=v1.noise_fn(seed, req.index, device))


def to_host(kept: dict) -> dict:
    """The conversion's intermediates on the host: ``logits`` (decoded
    positions, rows, vocab) f32 or None; ``source`` and ``reference``:
    ``features``, ``narrow``, ``wide``; ``chunks``: per CFM chunk its
    ``p_len``, ``w``, ``x`` (steps, 1, context, mels), the state of each step
    before ``EARLY_T``, and ``v`` (steps, 1, w, mels), its estimate over the
    generated frames; ``n_steps``, the schedule's steps."""
    from vcbench.ref.models.cfm import cosine_t_span
    rows = kept["ar_rows"]
    out = {"logits": None}
    if rows is not None:
        out["logits"] = rows["logits"][: int(rows["n_tokens"].max())].cpu()
    for side in SIDES:
        out[side] = {k: v.cpu() for k, v in kept[side].items()}
    out["chunks"] = []
    for c in kept["chunks"]:
        n = len(c["states"])
        k, p0 = int((cosine_t_span(n)[:n] < EARLY_T).sum()), c["p_len"]
        out["chunks"].append({"p_len": p0, "w": c["w"], "n_steps": n,
                              "x": c["states"][:k].cpu(),
                              "v": c["estimates"][:k, :, p0: p0 + c["w"]].cpu()})
    return out


def run(conv, tr: dict, req: T.Request, inp: v1.Inputs, seed: int, device, t0: float,
        profile: bool) -> Done:
    """One request through ``convert_voice_with_streaming``, its
    intermediates kept and brought to the host (every request pays the
    same)."""
    sr_in = int(tr["sample_rate"])
    d = Done(req=req, start=time.perf_counter() - t0)
    pieces, stats = [], None
    with torch.profiler.record_function("vcbench.request"):
        gen = conv.convert_voice_with_streaming(
            inp.source, sr_in, inp.reference, sr_in, profile=profile, keep_intermediates=True,
            **convert_kwargs(tr, req, seed, device))
        try:
            for _, piece, stats in gen:
                pieces.append(piece)
        finally:
            gen.close()
        t1 = time.perf_counter()
        d.kept = to_host(stats["kept"])
        t2 = time.perf_counter()
        d.keep_s, d.end = t2 - t1, t2 - t0
    rows = stats["kept"]["ar_rows"]
    d.wave = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    d.stages = stats["stages"]
    d.info = {"tokens": stats["kept"]["tokens"], "target_len": stats["target_len"],
              "plan": stats["plan"], "chunks": stats["chunks"],
              "decode_steps": stats["decode_steps"], "ar_batch": stats["ar_batch"],
              "rows": None if rows is None else {k: v for k, v in rows.items() if k != "logits"}}
    return d


def warm(conv, cfg: dict, tr: dict, inputs: dict, seed: int, device) -> int:
    """One two-step conversion per distinct plan of the cycle, the AR on for
    the first and for the longest source (the most AR rows), off for the
    rest (capped, it leaves the plan as it is): every shape the window
    meets, built before it opens."""
    cyc = T.cycle(tr)
    longest = max(cyc, key=lambda s: s["source_seconds"])["slot"]
    seen, ar_done = set(), 0
    for s in cyc:
        inp = inputs[s["slot"]]
        L = lengths(cfg, tr, inp)
        p = conv.plan_chunks(L["src_mel"], L["p_len"])
        with_ar = not ar_done or s["slot"] == longest
        if p in seen and not with_ar:
            continue
        seen.add(p)
        req = T.Request(index=-1 - len(seen) - ar_done, slot=s["slot"], source_seconds=0,
                        reference_seconds=0, steps=2)
        kw = convert_kwargs(tr, req, seed, device)
        kw["convert_style"] = with_ar and kw["convert_style"]
        conv.convert_voice(inp.source, int(tr["sample_rate"]), inp.reference,
                           int(tr["sample_rate"]), keep_intermediates=True, **kw)
        ar_done += int(with_ar)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return len(seen)


# ---------------------------------------------------------------------------
# lengths and operations

def lengths(cfg: dict, tr: dict, inp: v1.Inputs) -> dict:
    """The lengths the converter derives from the audio alone (resampling by
    ceil(n up / down); the reference cut to its cap)."""
    c = cfg["v2"]
    sr, hop = c["sr"], c["hop"]
    sr_in = int(tr["sample_rate"])

    def rs(n, new):
        g = math.gcd(sr_in, new)
        return n if new == sr_in else -(-n * (new // g) // (sr_in // g))

    ref_in = min(len(inp.reference), int(c["max_ref_sec"] * sr_in))
    src, src16 = rs(len(inp.source), sr), rs(len(inp.source), 16000)
    ref = min(rs(ref_in, sr), c["prompt_cap_frames"] * hop)
    ref16 = min(rs(ref_in, 16000), int(ref / sr * 16000))
    return dict(src16=src16, ref16=ref16, src_mel=src // hop, p_len=ref // hop)


def ar_lengths(info: dict) -> list[int]:
    """Each AR row's prefill length: [sep ‖ condition ‖ sep ‖ prompt]."""
    rows = info["rows"]
    return [2 + int(c) + rows["prompt_len"] for c in rows["cond_lens"]]


def chunk_widths(target_len: int, W: int) -> list[int]:
    ws, processed = [], 0
    while processed < target_len:
        w = min(W, target_len - processed)
        is_last = processed + W >= target_len
        ws.append(w)
        processed += w if is_last else (w - v1.OVERLAP_FRAMES)
    return ws


def conversion_ops(counter, cfg: dict, tr: dict, inp: v1.Inputs, d: Done) -> dict:
    """Operations of one conversion by precision: ``low`` (the bf16 parts:
    HuBERT, the quantizers, the AR, the DiT) and ``f32`` (CAMPPlus, the
    regulators, BigVGAN); ``k1``: the K1 launches and their least seconds."""
    L = lengths(cfg, tr, inp)
    info = d.info
    low = f32 = 0

    def bucket5(n):
        return -(-max(n, 8000) // 80000) * 80000

    for n16 in (L["src16"], L["ref16"]):
        b = bucket5(n16)
        low += counter.ssl(b) + counter.quantizers(b // 320)
    sb = -(-max(L["ref16"], 1600) // 16000) * 16000
    f32 += counter.style((sb - 400) // 160 + 1)
    tok = info["tokens"]

    def pad64(n):
        return -(-max(n, 1) // 64) * 64

    def b256(n):
        return -(-n // 256) * 256

    f32 += counter.regulate("cfm_reg", 1, pad64(tok["ref_wide"].shape[1]), b256(L["p_len"]))
    f32 += counter.regulate("cfm_reg", 1, pad64(tok["wide"].shape[1]), b256(info["target_len"]))
    rows = info["rows"]
    if rows is not None:
        C_max = b256(int(max(rows["cond_lens"])))
        f32 += counter.regulate("ar_reg", len(rows["cond_lens"]), C_max, C_max)
        lens = ar_lengths(info)
        low += counter.ar_prefill(lens) + counter.ar_decode(lens, rows["n_tokens"])
    cap, context, W = info["plan"]
    k1_n, k1_s = 0, 0.0
    for w in chunk_widths(info["target_len"], W):
        dense, attn = counter.sampler(context, d.req.steps, L["p_len"] + w)
        low += dense + attn
        f32 += counter.vocode(W)
        k1_n += d.req.steps * counter.depth
        k1_s += d.req.steps * counter.depth * counter.k1(context, L["p_len"] + w)
    return {"low": low, "f32": f32, "k1_launches": k1_n, "k1_bound_s": k1_s}


# ---------------------------------------------------------------------------
# the check

def rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(||a - b||^2, ||b||^2) in float64, for pooling; a shape that differs
    is an infinite error."""
    if a.shape != b.shape:
        return math.inf, 1.0
    a64, b64 = a.double().cpu(), b.double().cpu()
    return float(((a64 - b64) ** 2).sum()), float((b64 ** 2).sum())


def pooled(parts) -> float:
    num = sum(p[0] for p in parts)
    den = sum(p[1] for p in parts)
    return math.sqrt(num / den) if den > 0 else math.inf


def _under_fp8(modules, fn):
    """``fn()`` with ``modules``' products at fp8 (the control)."""
    from vcbench import control
    hooks = control.fp8(*modules)
    try:
        return fn()
    finally:
        for h in hooks:
            h.remove()


def _generated(chunks: list, estimates: list) -> list:
    """Per chunk of ``chunks`` (the kept ones), each step's estimate of
    ``estimates`` (per chunk, per step, over the whole window) cut to the
    chunk's generated frames; a chunk missing is None."""
    return [None if i >= len(estimates) else
            [e[:, c["p_len"]: c["p_len"] + c["w"]] for e in estimates[i]]
            for i, c in enumerate(chunks)]


def _estimate_err(prog: list, ref: list) -> float:
    """Pooled over every step of every chunk; a chunk or step missing on
    either side is an infinite error."""
    parts = []
    for p, r in zip(prog, ref):
        if p is None or r is None or len(p) != len(r):
            return math.inf
        parts += [rel(a, b) for a, b in zip(p, r)]
    return pooled(parts) if len(prog) == len(ref) else math.inf


def reference_readings(ref, tr: dict, inputs: dict, picks: list[Done], seed: int, device,
                       quantised: bool = False) -> dict:
    """The compared numbers of the picked requests: the program's kept
    numbers against the reference's, each stage on the program's inputs to
    it; with ``quantised``, the control's in the program's place (the
    reference with HuBERT, the quantizers, the AR and the DiT at fp8, the
    sampler's state too)."""
    from vcbench import control
    sr_in = int(tr["sample_rate"])
    logit_parts, feat, quant, est, wave_errs = [], [], [], [], []
    for d in picks:
        inp, k, tok = inputs[d.req.slot], d.kept, d.info["tokens"]
        _, _, src16, ref16 = ref.resampled(inp.source, sr_in, inp.reference, sr_in)

        def features():
            return [ref.content_features(w)[0].float().cpu() for w in (src16, ref16)]
        full = features()
        prog = (_under_fp8([ref.ssl], features) if quantised
                else [k[s]["features"].float() for s in SIDES])
        feat.append(pooled([rel(a, b) for a, b in zip(prog, full)]))

        def projections():
            return [h[0, : len(k[s]["narrow"])].cpu() for s in SIDES
                    for h in ref.projections(k[s]["features"][None].to(device))]
        full = projections()
        quantizers = [m for q in (ref.narrow, ref.wide)
                      for m in (q.encoder, q.quantizer.project_in)]
        prog = (_under_fp8(quantizers, projections) if quantised
                else [k[s][q].float() for s in SIDES for q in ("narrow", "wide")])
        quant.append(pooled([rel(a, b) for a, b in zip(prog, full)]))

        rows = d.info["rows"]
        if rows is not None:
            r = ref.ar_rows(tok["src_narrow"], tok["ref_narrow"], tok["ref_wide"])
            gen = [rows["tokens"][b, : int(n)] for b, n in enumerate(rows["n_tokens"])]
            full = ref.ar_logits(r, gen)
            prog = (_under_fp8([ref.ar], lambda: ref.ar_logits(r, gen)) if quantised
                    else [k["logits"][: len(g), b] for b, g in enumerate(gen)])
            logit_parts += [rel(p.float(), f.float()) for p, f in zip(prog, full)]

        states = [list(c["x"].to(device)) for c in k["chunks"]]
        kw = convert_kwargs(tr, d.req, seed, device)
        _, wave, info = ref.convert_voice(inp.source, sr_in, inp.reference, sr_in, tokens=tok,
                                          states=states, **kw)
        full = _generated(k["chunks"], info["estimates"])
        if quantised:
            kw = convert_kwargs(tr, d.req, seed, device)  # the same noise again
            _, low, qinfo = _under_fp8([ref.dit], lambda: ref.convert_voice(
                inp.source, sr_in, inp.reference, sr_in, tokens=tok, states=states,
                round_state=control.fake_fp8, **kw))
            wave_errs.append(v1.rel_err(low, wave))
            est.append(_estimate_err(_generated(k["chunks"], qinfo["estimates"]), full))
        else:
            wave_errs.append(v1.rel_err(d.wave, wave))
            est.append(_estimate_err([list(c["v"]) for c in k["chunks"]], full))
        del states
    worst = (lambda xs: max(xs) if xs else math.inf)
    return {"ar_logit_rel_err": pooled(logit_parts) if logit_parts else math.inf,
            "dit_est_rel_err": worst(est), "wave_rel_err": worst(wave_errs),
            "content_feat_rel_err": worst(feat), "quant_rel_err": worst(quant)}


def check(run, state: dict, builder) -> dict:
    """Compare the sampled requests' kept numbers with the reference's;
    returns {check name: (value, limit)}."""
    tr, cfg = run.traffic, run.config
    spec = tr["check"]
    picks = v1.sample(state["done"], int(spec["requests"]), run.seed)
    del state["conv"]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = builder.reference(cfg, run.device)
    builder.fill(ref, cfg, run.seed, run.device)
    got = reference_readings(ref, tr, state["inputs"], picks, run.seed, run.device)
    del ref
    gc.collect()
    run.log(f"reference over {len(picks)} requests in {time.perf_counter() - t0:.1f} s")
    return {k: (got[k], float(spec["limit"][k])) for k in CHECKED}
