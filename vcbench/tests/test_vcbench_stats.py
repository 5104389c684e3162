"""Percentiles and rates: a stall inside the window counts."""

import math

import numpy as np
import pytest

from vcbench import stats, traffic as T, v1
from vcbench.drivers import offline, stream


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 99) == 99
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1, 2, math.inf], 90) == math.inf


def _done(due, start, end, seconds=1.0, sr=22050):
    d = v1.Done(req=T.Request(0, 0, seconds, 1.0, 10, due=due), start=start, end=end)
    d.wave = np.zeros(int(seconds * sr), np.float32)
    return d


def test_stream_p99_counts_stalled_blocks():
    # 1,000 blocks of 22 ms, twelve of them stalled for 400 ms: the tail is a stall
    window = [{"dt": 0.022} for _ in range(988)] + [{"dt": 0.4} for _ in range(12)]
    assert stream.end_to_end(None, {"window": window})["block_p99_ms"] == pytest.approx(400.0)


class _Run:
    config = {"preset": {"preprocess_params": {"sr": 22050}}}
    seconds = 10.0


def test_offline_rate_spans_a_stall_inside_the_window():
    # 10 s of audio converted, a 5 s stall in the middle: the rate counts it
    state = {"done": [_done(0, 0, 1, 5.0), _done(0, 6, 8, 5.0)], "closed": 8.0}
    assert offline.end_to_end(_Run, state)["audio_s_per_s"] == pytest.approx(10.0 / 8.0)

