"""A tiny cell runs end to end on the CPU and prints the contract's line;
a new cell, configuration and per-layer metric are added as files alone."""

import json

import pytest

from conftest import run_cli, tiny_checkout


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_tiny_offline_cell_prints_the_contract_line(tmp_path):
    root = tiny_checkout(tmp_path)
    rc, out, err = run_cli(root, "--workload", "tiny.offline", "--seed", str(2**31 + 3),
                           "--seconds", "2", "--trace", "0")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert line["metrics"]["audio_s_per_s"]["unit"] == "audio-s/s"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert "wave_rel_err" in line["checks"]
    assert err.strip().splitlines()[-2].startswith("check wave_rel_err")


@pytest.mark.parametrize("cell,metric", [("tiny.stream", "block_p99_ms"),
                                         ("tiny.train", "train_frames_per_s")])
def test_each_driver_runs_a_tiny_cell(tmp_path, cell, metric):
    root = tiny_checkout(tmp_path)
    rc, out, err = run_cli(root, "--workload", cell, "--seed", "4", "--seconds", "2",
                           "--trace", "0")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True and set(line["metrics"]) == {metric, "setup_s"}


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """New files and new entries only: a configuration (a copy of the tiny
    one with another depth), a traffic mix, a per-layer metric; the harness
    finds each by its name."""
    root = tiny_checkout(tmp_path)
    pkg = root / "vcbench"
    cfg = json.loads((pkg / "configs" / "tiny_v1.json").read_text())
    cfg["preset"]["model_params"]["DiT"]["depth"] = 3
    (pkg / "configs" / "tiny_v1_deep.json").write_text(json.dumps(cfg))
    tr = json.loads((pkg / "traffic" / "tiny_offline.json").read_text())
    tr["steps"] = [[2, 1.0]]
    (pkg / "traffic" / "tiny_two_steps.json").write_text(json.dumps(tr))
    (pkg / "metrics" / "requests_done.deep.py").write_text(
        "def read(run):\n    return float(len(run.records.get('synced', [])))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_v1_deep", "source": "tests",
                             "file": "vcbench/configs/tiny_v1_deep.json", "reduced": [],
                             "why": "deeper"})
    bench["workloads"].append({"name": "deep.two_steps", "config": "tiny_v1_deep",
                               "traffic": "tiny_two_steps", "chips": 1, "why": "added"})
    bench["end_to_end"][0]["workloads"].append("deep.two_steps")
    bench["per_layer"].append({"name": "requests_done.deep", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "audio_s_per_s",
                               "workloads": ["deep.two_steps"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cli(root, "--workload", "deep.two_steps", "--seed", "5",
                           "--seconds", "2", "--trace", "1")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True
    assert line["metrics"]["requests_done.deep"]["value"] >= 1
    assert "breakdown" in line and "busy_s" in line["device"]


def test_no_result_without_a_card(tmp_path):
    import subprocess
    import sys
    root = tiny_checkout(tmp_path)
    out = subprocess.run([sys.executable, "-c",
                          "import sys, torch; torch.cuda.is_available = lambda: False\n"
                          "from vcbench.run import main\n"
                          "sys.exit(main(['--workload', 'tiny.offline', '--seed', '1',"
                          " '--seconds', '1']))"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""


def test_no_result_in_a_bare_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    port) exits with an error and prints no result."""
    import os
    import shutil
    import subprocess
    import sys
    from conftest import REPO
    shutil.copytree(REPO / "vcbench", tmp_path / "vcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "vcbench", "--workload", "v1_offline",
                          "--seed", "1", "--seconds", "1", "--device", "cpu"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
