"""The SVC cell, tiny, on the CPU: an F0-conditioned configuration and a
sung traffic mix added to a tiny checkout as files and entries alone print
the contract's line with its three checks and ``correct`` true; each
planted fault fails its check, and the control fails at least one; the
``f0`` spans and counters are in the traced line's records and agree with
each other; the readers give None without them; the builder refuses a port
that keeps no intermediates; the reference and the harness load neither
JAX nor the JAX package."""

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from vcbench import readers_svc, run as vrun, svc

from conftest import FIXTURES, REPO, run_cli, tiny_checkout

CELL = "tiny.svc"


def svc_checkout(tmp_path):
    """A tiny checkout with the tiny SVC configuration and traffic added as
    new files, the cell appended to ``audio_s_per_s``'s cells and the SVC
    per-layer metrics of the real BENCHMARK.json listed for it."""
    root = tiny_checkout(tmp_path)
    pkg = root / "vcbench"
    shutil.copy(FIXTURES / "tiny_svc.json", pkg / "configs" / "tiny_svc.json")
    shutil.copy(FIXTURES / "tiny_svcoffline.json", pkg / "traffic" / "tiny_svcoffline.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_svc", "source": "tests",
                             "file": "vcbench/configs/tiny_svc.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": CELL, "config": "tiny_svc",
                               "traffic": "tiny_svcoffline", "chips": 1, "why": "tiny"})
    bench["end_to_end"][0]["workloads"].append(CELL)
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["per_layer"] += [dict(m, workloads=[CELL]) for m in real["per_layer"]
                           if "svc_offline" in m.get("workloads", [])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_the_tiny_svc_cell_prints_the_contract_line(tmp_path):
    root = svc_checkout(tmp_path)
    rc, out, err = run_cli(root, "--workload", CELL, "--seed", str(2**33 + 5), "--seconds",
                           "2", "--trace", "0")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(line["checks"]) == set(svc.CHECKED)
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_the_traced_tiny_svc_run_reads_its_span_metrics(tmp_path, capsys):
    """On the CPU the ``f0`` stage's host seconds and the whole-step share
    are read; the device times and the kernels' launches are not there. The
    ``f0`` spans and counters agree: both GRU scans run every padded frame,
    the real frames are the source's and the reference's."""
    root = svc_checkout(tmp_path)
    rc = vrun.main(["--workload", CELL, "--seed", "21", "--seconds", "2", "--trace", "1",
                    "--device", "cpu"], root=root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and "breakdown" in line
    m = line["metrics"]
    assert {"f0_s_per_audio_s.svc", "convert_mfu.svc", "device_idle.svc"} <= set(m)
    assert 0 < m["f0_s_per_audio_s.svc"]["value"] and 0 < m["convert_mfu.svc"]["value"] <= 100
    assert not {"f0_gru_us_per_step.svc", "k1_roofline.svc", "k2_roofline.svc",
                "sampler_device_ms_per_step.svc", "vocode_device_s_per_audio_s.svc"} & set(m)


def test_the_f0_spans_and_counters_agree(tmp_path):
    from vcbench import spec, traffic as T
    root = svc_checkout(tmp_path)
    cell = spec.load_cell(root, CELL)
    bld = spec.builder(cell.config, cell.base)
    conv = bld.program(cell.config, "cpu")
    bld.fill(conv, cell.config, 3, "cpu")
    inputs = svc.make_inputs(cell.traffic, 3)
    s = T.cycle(cell.traffic)[-1]
    req = T.Request(0, s["slot"], s["source_seconds"], s["reference_seconds"], 2)
    d = svc.run(conv, cell.traffic, req, inputs[s["slot"]], 3, conv.device, 0.0, True)
    st = d.stages
    sal, gru = st["f0.salience"], st["f0.gru"]
    assert sal["calls"] == gru["calls"] == st["f0.decode"]["calls"] == 2
    assert gru["gru_steps"] == 2 * sal["padded_frames"]
    n = [len(d.kept["salience"][side]) for side in svc.SIDES]
    assert sal["frames"] == sum(n) and sal["padded_frames"] == sum(-(-k // 32) * 32 for k in n)
    assert st["f0"]["seconds"] >= sal["seconds"] + st["f0.decode"]["seconds"]
    assert sal["seconds"] >= gru["seconds"]
    assert all(st[k]["device_seconds"] is None for k in ("f0", "f0.salience", "f0.gru"))


@pytest.mark.parametrize("fault,check", [("late", "cond_rel_err"),
                                         ("unflipped", "f0_salience_rel_err"),
                                         ("mask", "cond_rel_err")])
def test_each_planted_fault_fails_its_check(tmp_path, capsys, fault, check):
    """The F0 one frame late, or the F0 embedding left out for its mask,
    fails the conditions; the backward GRU over the frames in their own
    order fails the salience."""
    from vcbench import calibrate_svc
    root = svc_checkout(tmp_path)
    undo = calibrate_svc.FAULTS[fault]()
    try:
        rc = vrun.main(["--workload", CELL, "--seed", "13", "--seconds", "1.5", "--trace", "0",
                        "--device", "cpu"], root=root)
    finally:
        undo()
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"][check]["value"] > line["checks"][check]["limit"]


def test_the_control_fails_the_tiny_svc_cell(tmp_path, capsys, monkeypatch):
    from vcbench import calibrate_svc, spec
    root = svc_checkout(tmp_path)
    monkeypatch.chdir(root)
    calibrate_svc.main(["--workload", CELL, "--seeds", "", "--control-seeds", "5",
                        "--device", "cpu"])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ctrl = next(r for r in rows if r.get("side") == "control")
    limits = spec.load_cell(root, CELL).traffic["check"]["limit"]
    assert any(ctrl[k] > limits[k] for k in limits)
    assert all(0 <= f["voiced_share"] <= 1 and f["coarse_bins"] >= 0 for f in ctrl["f0"])


def test_the_readers_give_none_without_the_f0_spans():
    cfg = {"preset": {"preprocess_params": {"sr": 44100}}}
    done = SimpleNamespace(wave=np.zeros(44100, np.float32),
                           stages={"sample+vocode": {"seconds": 1.0, "calls": 1}})
    for records in ({"synced": [done]}, {}):
        run = SimpleNamespace(config=cfg, records=records, subwindow=None)
        assert readers_svc.f0_s_per_audio_s(run) is None
        assert readers_svc.f0_gru_us_per_step(run) is None
        assert readers_svc.convert_mfu(run) is None


def test_the_builder_refuses_a_port_without_kept_intermediates(monkeypatch):
    """The parent's port keeps nothing: set-up fails at once."""
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter
    from vcbench.builders import svc_converter

    def old(self, source, source_sr, reference, reference_sr, *, profile=False):
        yield from ()
    monkeypatch.setattr(VoiceConverter, "convert_with_streaming", old)
    cfg = json.loads((FIXTURES / "tiny_svc.json").read_text())
    with pytest.raises(RuntimeError, match="keep_intermediates"):
        svc_converter.program(cfg, "cpu")


def test_the_svc_reference_and_harness_load_no_jax():
    code = ("import vcbench.ref.pipelines.convert_svc, vcbench.ref.models.rmvpe\n"
            "import sys\nref = {m.split('.')[0] for m in sys.modules}\n"
            "import vcbench.svc, vcbench.readers_svc, vcbench.calibrate_svc\n"
            "from vcbench.drivers import offline_svc\n"
            "from vcbench.builders import svc_converter\n"
            "import seedvc_tpu_torch.pipelines.convert\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(' '.join(sorted(ref)), '|', ' '.join(sorted(top)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ref, top = (set(x.split()) for x in out.split("|"))
    assert not {"seedvc_tpu_torch", "seedvc_tpu", "jax", "jaxlib", "flax"} & ref
    assert not {"jax", "jaxlib", "flax", "seedvc_tpu"} & top and "seedvc_tpu_torch" in top


def test_rmvpe_is_counted_as_the_reference_runs_it():
    """The counter's RMVPE (the U-Net on the meta device, the GRU scans a
    frame times the frames, the output layer) against torch's counter over
    the reference's forward on real tensors, every frame padded to 32."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from vcbench.builders import svc_converter
    from vcbench.ref.models.rmvpe import RMVPE_E2E
    cfg = json.loads((FIXTURES / "tiny_svc.json").read_text())
    c = svc_converter.Counter(cfg)
    model = RMVPE_E2E(**cfg["rmvpe"])
    n16 = 16000 * 2 + 123
    frames = -(-(1 + n16 // 160) // 32) * 32
    with FlopCounterMode(display=False) as m:
        model(torch.zeros(1, frames, 128))
    assert c.rmvpe(n16) == m.get_total_flops() > 0
    assert c.whisper_window() == svc_converter.v1b.Counter(cfg).whisper_window()
