"""The v2 cell, tiny, on the CPU: a v2 configuration and traffic mix added
to a tiny checkout as files and entries alone print the contract's line
with ``correct`` true; a planted fault in the decode, the sampler or the
content stage fails that stage's comparison, and the control fails every
one; the builder refuses a port without the AR's cap at once;
the reference and the harness load neither JAX nor the JAX package."""

import json
import shutil
import subprocess
import sys

import pytest

from vcbench import run as vrun, v2

from conftest import FIXTURES, REPO, run_cli, tiny_checkout

CELL = "tiny.v2"


def v2_checkout(tmp_path):
    """A tiny checkout with the tiny v2 configuration and traffic added as
    new files, the cell appended to ``audio_s_per_s``'s cells and the v2
    per-layer metrics of the real BENCHMARK.json listed for it."""
    root = tiny_checkout(tmp_path)
    pkg = root / "vcbench"
    shutil.copy(FIXTURES / "tiny_v2.json", pkg / "configs" / "tiny_v2.json")
    shutil.copy(FIXTURES / "tiny_v2voice.json", pkg / "traffic" / "tiny_v2voice.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_v2", "source": "tests",
                             "file": "vcbench/configs/tiny_v2.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": CELL, "config": "tiny_v2", "traffic": "tiny_v2voice",
                               "chips": 1, "why": "tiny"})
    bench["end_to_end"][0]["workloads"].append(CELL)
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["per_layer"] += [dict(m, workloads=[CELL]) for m in real["per_layer"]
                           if "v2_voice" in m.get("workloads", [])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_the_tiny_v2_cell_prints_the_contract_line(tmp_path):
    root = v2_checkout(tmp_path)
    rc, out, err = run_cli(root, "--workload", CELL, "--seed", str(2**31 + 7), "--seconds", "2",
                           "--trace", "0")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(line["checks"]) == set(v2.CHECKED)
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_the_traced_tiny_v2_run_reads_its_span_metrics(tmp_path):
    """On the CPU the spans' host seconds and counters are read; the device
    times, K1's launches and the decode's device time are not there."""
    root = v2_checkout(tmp_path)
    rc, out, err = run_cli(root, "--workload", CELL, "--seed", "12", "--seconds", "2",
                           "--trace", "1")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True and "breakdown" in line
    m = line["metrics"]
    assert {"convert_mfu.v2", "device_idle.v2", "ar_s_per_audio_s.v2",
            "sampler_host_ms_per_step.v2"} <= set(m)
    assert 0 < m["ar_s_per_audio_s.v2"]["value"] and 0 < m["convert_mfu.v2"]["value"] <= 100
    assert not {"ar_step_device_ms.v2", "ar_decode_roofline.v2", "k1_roofline.v2",
                "k2_roofline.v2", "vocode_device_s_per_audio_s.v2"} & set(m)


@pytest.mark.parametrize("fault", ["kv", "rope"])
def test_a_planted_decode_fault_fails_the_logits(tmp_path, capsys, fault):
    from vcbench import calibrate_v2
    root = v2_checkout(tmp_path)
    undo = calibrate_v2.FAULTS[fault]()
    try:
        rc = vrun.main(["--workload", CELL, "--seed", "11", "--seconds", "1.5", "--trace", "0",
                        "--device", "cpu"], root=root)
    finally:
        undo()
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    check = line["checks"]["ar_logit_rel_err"]
    assert line["correct"] is False and check["value"] > check["limit"]


@pytest.mark.parametrize("fault,check", [("branch", "dit_est_rel_err"),
                                         ("lens", "dit_est_rel_err"),
                                         ("shift", "content_feat_rel_err")])
def test_a_planted_sampler_or_content_fault_fails_its_stage(tmp_path, capsys, fault, check):
    """The text-only CFG branch left out, or the padded frames attended,
    fails the teacher-forced estimates; HuBERT's 16 kHz wave one sample
    late fails the features kept from the timed path."""
    from vcbench import calibrate_v2
    root = v2_checkout(tmp_path)
    undo = calibrate_v2.FAULTS[fault]()
    try:
        rc = vrun.main(["--workload", CELL, "--seed", "13", "--seconds", "1.5", "--trace", "0",
                        "--device", "cpu"], root=root)
    finally:
        undo()
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and line["checks"][check]["value"] > line["checks"][check][
        "limit"]


def test_the_control_fails_the_tiny_v2_cell(tmp_path, capsys, monkeypatch):
    from vcbench import calibrate_v2, spec
    root = v2_checkout(tmp_path)
    monkeypatch.chdir(root)
    calibrate_v2.main(["--workload", CELL, "--seeds", "", "--control-seeds", "5",
                       "--device", "cpu"])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ctrl = next(r for r in rows if r.get("side") == "control")
    limits = spec.load_cell(root, CELL).traffic["check"]["limit"]
    assert all(ctrl[k] > limits[k] for k in limits)


def test_the_builder_refuses_a_port_without_the_cap(monkeypatch):
    """The parent's port lacks ``cap_to_source``: set-up fails at once."""
    from seedvc_tpu_torch.pipelines.convert_v2 import VoiceConverterV2
    from vcbench.builders import v2_converter

    def old(self, source, source_sr, reference, reference_sr, *, profile=False):
        yield from ()
    monkeypatch.setattr(VoiceConverterV2, "convert_voice_with_streaming", old)
    cfg = json.loads((FIXTURES / "tiny_v2.json").read_text())
    with pytest.raises(RuntimeError, match="cap_to_source"):
        v2_converter.program(cfg, "cpu")


def test_the_v2_reference_and_harness_load_no_jax():
    code = ("import vcbench.ref.pipelines.convert_v2, vcbench.control\n"
            "import sys\nref = {m.split('.')[0] for m in sys.modules}\n"
            "import vcbench.v2, vcbench.readers_v2, vcbench.calibrate_v2\n"
            "from vcbench.drivers import offline_v2\n"
            "from vcbench.builders import v2_converter\n"
            "import seedvc_tpu_torch.pipelines.convert_v2\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(' '.join(sorted(ref)), '|', ' '.join(sorted(top)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ref, top = (set(x.split()) for x in out.split("|"))
    assert not {"seedvc_tpu_torch", "seedvc_tpu", "jax", "jaxlib", "flax"} & ref
    assert not {"jax", "jaxlib", "flax", "seedvc_tpu"} & top and "seedvc_tpu_torch" in top
