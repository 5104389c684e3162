"""The metrics read from the program's own spans (``vcbench/spans.py``): each
tiny cell's traced line carries the host-side ones on the CPU and leaves the
device-side ones out (no card, no events); every reader gives None, and
raises nothing, on records of a program that keeps none of those spans."""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import REPO, run_cli, tiny_checkout
from vcbench import spans

CELLS = {
    "tiny.offline": ("audio_s_per_s", {"sampler_host_ms_per_step.offline": True,
                                       "sampler_device_ms_per_step.offline": False,
                                       "vocode_device_s_per_audio_s.offline": False}),
    "tiny.stream": ("block_p99_ms", {"block_device_ms.stream": False,
                                     "encoder_device_ms.stream": False,
                                     "block_host_ms.stream": True}),
    "tiny.train": ("train_frames_per_s", {"queue_wait_ms.train": True,
                                          "step_host_ms.train": True,
                                          "step_device_ms.train": False}),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_tiny_cell_reads_its_span_metrics(tmp_path, cell):
    moves, metrics = CELLS[cell]
    root = tiny_checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in metrics:
        tiny = name.rsplit(".", 1)[0] + ".tiny"
        shutil.copy(REPO / "vcbench" / "metrics" / f"{name}.py",
                    root / "vcbench" / "metrics" / f"{tiny}.py")
        bench["per_layer"].append({"name": tiny, "unit": "ms", "better": "lower",
                                   "source": "program_span", "layer": "spans", "moves": moves,
                                   "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cli(root, "--workload", cell, "--seed", str(2**31 + 11), "--seconds",
                           "2", "--trace", "1")
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    for name, on_cpu in metrics.items():
        tiny = name.rsplit(".", 1)[0] + ".tiny"
        assert (tiny in line["metrics"]) is on_cpu, (tiny, line["metrics"])
        if on_cpu:
            assert line["metrics"][tiny]["value"] >= 0


def test_readers_give_none_without_the_spans():
    """A program without spans: stages without ``sample`` / ``vocode``, a
    stream without ``timings``, a history without the step fields."""
    cfg = {"preset": {"preprocess_params": {"sr": 22050}}}
    done = SimpleNamespace(wave=np.zeros(22050, np.float32),
                           stages={"sample+vocode": {"seconds": 1.0, "calls": 1}})
    offline = SimpleNamespace(config=cfg, records={"synced": [done]})
    stream = SimpleNamespace(records={"stream": object(), "window": [{"k": 0}] * 3})
    train = SimpleNamespace(records={"window": [{"step": 1, "prep_s": 0.1}]})
    for fn, run in ((spans.sampler_host_ms_per_step, offline),
                    (spans.sampler_device_ms_per_step, offline),
                    (spans.vocode_device_s_per_audio_s, offline),
                    (spans.block_device_ms, stream), (spans.encoder_device_ms, stream),
                    (spans.block_host_ms, stream), (spans.queue_wait_ms, train),
                    (spans.step_host_ms, train), (spans.step_device_ms, train)):
        assert fn(run) is None, fn.__name__
        assert fn(SimpleNamespace(config=cfg, records={})) is None, fn.__name__


def test_stream_readers_take_the_window_blocks():
    """The window's blocks are the stream's last records; gated ones and
    blocks whose events had not completed are left out."""
    def rec(gated, enc=None, total=3.0):
        r = {"gated": gated, "total_ms": total, "sync_ms": 2.0}
        return r if gated else {**r, "encode_ms": enc, "cfm_ms": 1.0, "vocode_ms": 0.5}
    timings = [rec(False, 100.0)] + [rec(False, 1.0), rec(True), rec(False, 2.0, 4.0),
                                     rec(False, None)]
    run = SimpleNamespace(records={"stream": SimpleNamespace(timings=timings),
                                   "window": [{}] * 4})
    assert spans.encoder_device_ms(run) == 1.5
    assert spans.block_device_ms(run) == 3.0
    assert spans.block_host_ms(run) == 1.0
