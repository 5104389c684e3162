"""The singing-voice-conversion cell (an F0-conditioned v1 preset): its
singing inputs, its requests' arguments, what a finished request keeps for
the readers and the check, the operations of a conversion (RMVPE
included), and the comparison with the frozen reference.

Every request runs with ``keep_intermediates``: the numbers compared are
those the timed conversion computed, brought to the host once it has
returned. Each stage is held against the reference on the program's own
inputs to it:

- ``f0_salience_rel_err``: RMVPE's salience of the source and the reference
  against the reference RMVPE's on the same 16 kHz audio, pooled over both
  sides' frames (the salience, not the decoded F0: an argmax flips on
  rounding);
- ``cond_rel_err``: the regulator's ``cond`` and ``prompt_cond`` against the
  reference regulator's on the program's content features and on the F0
  that the reference decodes (and shifts) from the program's own salience,
  pooled over both;
- ``wave_rel_err``: the reference's regulator, sampler and BigVGAN on the
  program's content features, that F0 and the same noise, against the
  program's wave.

Each is the worst of the checked requests (the window's longest finished
request and one drawn from the seed).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from vcbench import control, traffic as T, v1, v2
from vcbench.singing import singing_like

CHECKED = ("f0_salience_rel_err", "cond_rel_err", "wave_rel_err")
SIDES = ("source", "reference")


@dataclass
class Done(v1.Done):
    """An SVC request's outcome; ``kept``: the conversion's intermediates
    on the host (:func:`to_host`); ``keep_s``: the seconds bringing them
    there took."""
    kept: dict | None = None
    keep_s: float = 0.0


def make_inputs(tr: dict, seed: int) -> dict[int, v1.Inputs]:
    """Each cycle slot's singing source and reference, from the seed."""
    sr, p = int(tr["sample_rate"]), tr.get("audio")
    return {s["slot"]: v1.Inputs(
        singing_like(s["source_seconds"], sr, T.rng(seed, 2, s["slot"]), p),
        singing_like(s["reference_seconds"], sr, T.rng(seed, 3, s["slot"]), p))
        for s in T.cycle(tr)}


def f0_kwargs(tr: dict) -> dict:
    return dict(auto_f0_adjust=bool(tr["auto_f0_adjust"]),
                pitch_shift=float(tr["pitch_shift"]))


def convert_kwargs(tr: dict, req: T.Request, seed: int, device) -> dict:
    return {**v1.convert_kwargs(tr, req, seed, device), **f0_kwargs(tr)}


def to_host(kept: dict) -> dict:
    """The kept intermediates on the host: ``salience``, ``f0``, ``coarse``
    and ``features`` by side, ``cond`` and ``prompt_cond``."""
    out = {k: kept[k] for k in ("salience", "f0")}
    out["coarse"] = {s: kept["coarse"][s].cpu() for s in SIDES}
    out["features"] = {s: kept["features"][s].cpu() for s in SIDES}
    out["cond"], out["prompt_cond"] = kept["cond"].cpu(), kept["prompt_cond"].cpu()
    return out


def run(conv, tr: dict, req: T.Request, inp: v1.Inputs, seed: int, device, t0: float,
        profile: bool) -> Done:
    """One request through ``convert_with_streaming``, its intermediates
    kept and brought to the host (every request pays the same)."""
    sr_in = int(tr["sample_rate"])
    d = Done(req=req, start=time.perf_counter() - t0)
    pieces, stats = [], None
    with torch.profiler.record_function("vcbench.request"):
        gen = conv.convert_with_streaming(inp.source, sr_in, inp.reference, sr_in,
                                          profile=profile, keep_intermediates=True,
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
    d.wave = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    d.stages = stats["stages"]
    return d


def conversion_ops(counter, cfg: dict, L: dict, steps: int) -> dict:
    """v1's operations of a conversion (``v1.conversion_ops``) with RMVPE
    over the source and the reference at f32."""
    ops = v1.conversion_ops(counter, cfg, L, steps)
    ops["f32"] += counter.rmvpe(L["src16"]) + counter.rmvpe(L["ref16"])
    return ops


def f0_share(kept: dict, n_bins: int) -> dict:
    """The fill's F0 on the traffic: the voiced share of the source's frames
    and the distinct coarse bins of its voiced frames."""
    f0, coarse = kept["f0"]["source"], kept["coarse"]["source"].numpy()
    voiced = f0 > 1
    return {"voiced_share": float(voiced.mean()) if len(f0) else 0.0,
            "coarse_bins": int(len(np.unique(coarse[voiced]))), "n_bins": n_bins}


# ---------------------------------------------------------------------------
# the check

@contextlib.contextmanager
def tf32():
    """TF32 on for cuDNN and matmuls (the control's RMVPE), then back."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def fp8_sampler(ref):
    """The reference's DiT at fp8 and its sampler's state held in fp8 (the
    control's bf16 parts)."""
    from vcbench.ref.pipelines import convert as ref_convert
    hooks = control.fp8(ref.vc.cfm.estimator)
    sampler = ref_convert.euler_solve
    ref_convert.euler_solve = control.euler_solve_fp8
    try:
        yield
    finally:
        ref_convert.euler_solve = sampler
        for h in hooks:
            h.remove()


def program_f0(tr: dict, salience: dict) -> tuple[np.ndarray, np.ndarray]:
    """(the source's shifted F0, the reference's F0) as the reference
    decodes and shifts them from a given salience of each side."""
    from vcbench.ref.models.rmvpe import decode_f0
    from vcbench.ref.pipelines.convert_svc import shift_f0
    f0_ori = decode_f0(salience["reference"])
    kw = f0_kwargs(tr)
    return shift_f0(decode_f0(salience["source"]), f0_ori, kw["auto_f0_adjust"],
                    kw["pitch_shift"]), f0_ori


def reference_readings(ref, tr: dict, inputs: dict, picks: list[Done], seed: int, device,
                       quantised: bool = False) -> dict:
    """The compared numbers of the picked requests: the program's kept
    numbers against the reference's, each stage on the program's inputs to
    it; with ``quantised``, the control's in the program's place (the
    reference with RMVPE in TF32, the DiT and the sampler's state at
    fp8)."""
    sr_in = int(tr["sample_rate"])
    sal_errs, cond_errs, wave_errs = [], [], []
    for d in picks:
        inp, k = inputs[d.req.slot], d.kept
        src, _, src16, ref16 = ref.prepared(inp.source, sr_in, inp.reference, sr_in)
        full = {"source": ref.salience(src16), "reference": ref.salience(ref16)}
        if quantised:
            with tf32():
                sal = {"source": ref.salience(src16), "reference": ref.salience(ref16)}
        else:
            sal = k["salience"]
        sal_errs.append(v2.pooled([v2.rel(torch.from_numpy(sal[s]), torch.from_numpy(full[s]))
                                   for s in SIDES]))

        f0 = program_f0(tr, sal)
        feats = tuple(k["features"][s].to(device) for s in SIDES)
        info = {}
        kw = convert_kwargs(tr, d.req, seed, device)
        with torch.no_grad():
            _, wave, _ = ref.convert(inp.source, sr_in, inp.reference, sr_in, features=feats,
                                     f0=f0, info=info, **kw)
            if quantised:
                kw = convert_kwargs(tr, d.req, seed, device)  # the same noise again
                with fp8_sampler(ref):
                    _, low, _ = ref.convert(inp.source, sr_in, inp.reference, sr_in,
                                            features=feats, f0=f0, **kw)
                prog = {"cond": info["cond"], "prompt_cond": info["prompt_cond"]}
            else:
                low, prog = d.wave, k
        cond_errs.append(v2.pooled([v2.rel(prog[c][0].float(), info[c][0].float())
                                    for c in ("cond", "prompt_cond")]))
        wave_errs.append(v1.rel_err(low, wave))
        del feats, info
    worst = (lambda xs: max(xs) if xs else math.inf)
    return {"f0_salience_rel_err": worst(sal_errs), "cond_rel_err": worst(cond_errs),
            "wave_rel_err": worst(wave_errs)}


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
    n_bins = cfg["preset"]["model_params"]["length_regulator"]["n_f0_bins"]
    shares = [f0_share(d.kept, n_bins) for d in picks]
    run.log(f"reference over {len(picks)} requests in {time.perf_counter() - t0:.1f} s; "
            f"the fill's F0 on them: {shares}")
    return {k: (got[k], float(spec["limit"][k])) for k in CHECKED}
