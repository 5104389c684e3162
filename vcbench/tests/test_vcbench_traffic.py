"""The traffic generator and the audio are deterministic for each seed, and
every seed gets the same multiset of work."""

import json

import numpy as np
import pytest

from vcbench import traffic as T
from vcbench.audio import speech_like
from vcbench.v1 import make_inputs

from conftest import REPO

SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]
TRAFFIC = ["v1_offline"]


def load(name):
    return json.loads((REPO / "vcbench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", TRAFFIC)
@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_is_the_same_for_the_same_seed(name, seed):
    tr = load(name)
    a = [(r.slot, r.steps, r.due) for r, _ in zip(T.stream(tr, seed), range(60))]
    b = [(r.slot, r.steps, r.due) for r, _ in zip(T.stream(tr, seed), range(60))]
    assert a == b


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_seed_gets_the_same_work_in_another_order(name):
    tr = load(name)
    n = int(tr["requests"])
    works, orders = set(), set()
    for seed in SEEDS:
        reqs = [r for r, _ in zip(T.stream(tr, seed), range(2 * n))]
        works.add(tuple(sorted((r.source_seconds, r.reference_seconds, r.steps)
                               for r in reqs)))
        orders.add(tuple(r.slot for r in reqs))
        if "rate" in tr.get("arrivals", {}):
            gaps = sorted(round(b.due - a.due, 12) for a, b in zip(reqs[:n], reqs[1:n + 1]))
            ref = sorted(round(-np.log(1 - (i + 0.5) / n) / tr["arrivals"]["rate"], 12)
                         for i in range(n))
            assert len(set(gaps) - set(ref)) <= 1  # one gap a cycle is the wrap's
    assert len(works) == 1
    assert len(orders) == len(SEEDS)


def test_step_mix_counts():
    assert sorted(T.step_mix([[10, 0.7], [25, 0.25], [50, 0.05]], 20)) == \
        [10] * 14 + [25] * 5 + [50]


@pytest.mark.parametrize("seed", SEEDS)
def test_audio_is_the_same_for_the_same_seed(seed):
    a = speech_like(3.0, 22050, T.rng(seed, 2, 0))
    b = speech_like(3.0, 22050, T.rng(seed, 2, 0))
    c = speech_like(3.0, 22050, T.rng(seed + 1, 2, 0))
    assert a.dtype == np.float32 and len(a) == 66150
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.isfinite(a).all() and np.abs(a).max() < 1


def test_inputs_follow_the_cycle():
    tr = json.loads((REPO / "vcbench" / "tests" / "fixtures" / "tiny_offline.json").read_text())
    inputs = make_inputs(tr, 3)
    for s in T.cycle(tr):
        assert len(inputs[s["slot"]].source) == round(s["source_seconds"] * tr["sample_rate"])
