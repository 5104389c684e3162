"""The one traffic generator: a traffic file's parameters and a seed in,
a list of requests out.

Every seed gets the same multiset of work: a cycle of ``requests`` sizes
taken at the quantiles ``(i + 0.5) / n`` of each distribution, and (for an
open loop) the same gaps between arrivals. The seed chooses their order, the
audio and the noise, so runs with different seeds differ in what they hear,
not in how much there is to do.

Distributions (each clipped to ``min`` / ``max`` where given):
``{"lognormal": {"median": m, "sigma": s}}``, ``{"uniform": {"low": a,
"high": b}}``, ``{"fixed": v}``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Request:
    index: int             # position in the schedule
    slot: int              # position in the cycle (the audio is the slot's)
    source_seconds: float
    reference_seconds: float
    steps: int
    due: float = 0.0       # seconds after the window opens (open loop)


def quantile(dist: dict, u: float) -> float:
    if "fixed" in dist:
        x = float(dist["fixed"])
    elif "lognormal" in dist:
        p = dist["lognormal"]
        x = float(p["median"]) * math.exp(float(p["sigma"]) * NormalDist().inv_cdf(u))
    elif "uniform" in dist:
        p = dist["uniform"]
        x = float(p["low"]) + u * (float(p["high"]) - float(p["low"]))
    else:
        raise ValueError(f"unknown distribution {dist}")
    return min(max(x, float(dist.get("min", -math.inf))), float(dist.get("max", math.inf)))


def cycle_values(dist: dict, n: int) -> list[float]:
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


def step_mix(mix: list, n: int) -> list[int]:
    """``[[steps, share], ...]`` as n counts by largest remainder, laid out
    so that every size rank gets steps in the same pattern for every seed."""
    shares = [float(s) for _, s in mix]
    exact = [n * s / sum(shares) for s in shares]
    counts = [int(math.floor(e)) for e in exact]
    for i in sorted(range(len(mix)), key=lambda i: exact[i] - counts[i], reverse=True):
        if sum(counts) >= n:
            break
        counts[i] += 1
    # interleave: the rarest step count first, spread evenly over the ranks
    slots: list[tuple[float, int]] = []
    for (steps, _), c in zip(mix, counts):
        slots += [((j + 0.5) / c, int(steps)) for j in range(c)]
    return [s for _, s in sorted(slots)]


def cycle(traffic: dict) -> list[dict]:
    """The cycle's sizes in rank order (seed-free)."""
    n = int(traffic["requests"])
    src = cycle_values(traffic["source_seconds"], n)
    ref_vals = cycle_values(traffic["reference_seconds"], n)
    # references paired against sources in reverse rank, so every cycle
    # holds short sources with long prompts and the reverse
    ref = ref_vals[::-1]
    steps = step_mix(traffic.get("steps", [[25, 1.0]]), n)
    return [{"slot": i, "source_seconds": src[i], "reference_seconds": ref[i],
             "steps": steps[i]} for i in range(n)]


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed (any whole seed)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, *stream])


def stream(traffic: dict, seed: int):
    """Requests in the order they are sent, without end: cycles of the
    traffic's sizes, each cycle in its own seeded order. An open loop
    (``arrivals`` with a ``rate``) gets due times from exponential gaps at
    the same quantiles in every cycle, shuffled by the seed."""
    base = cycle(traffic)
    n = len(base)
    rate = traffic.get("arrivals", {}).get("rate")
    gaps = None if rate is None else [
        -math.log(1.0 - (i + 0.5) / n) / float(rate) for i in range(n)]
    t, index, c = 0.0, 0, 0
    while True:
        g = rng(seed, 1, c)
        order, gap_order = g.permutation(n), g.permutation(n)
        for j, k in enumerate(order):
            spec = base[int(k)]
            yield Request(index=index, slot=spec["slot"],
                          source_seconds=spec["source_seconds"],
                          reference_seconds=spec["reference_seconds"],
                          steps=spec["steps"], due=t)
            index += 1
            if gaps is not None:
                t += gaps[int(gap_order[j])]
        c += 1


def due_before(traffic: dict, seed: int, horizon_s: float) -> list[Request]:
    """An open loop's requests due before ``horizon_s``."""
    out = []
    for r in stream(traffic, seed):
        if r.due >= horizon_s:
            return out
        out.append(r)
