"""Shared fixtures of the benchmark's own tests (run from the repository's
root: ``python -m pytest vcbench/tests -q``). They run on the CPU at tiny
sizes; a test that needs the card carries the ``cuda`` marker and decides in
a fixture."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_checkout(tmp_path: Path, cells=("tiny.offline",)) -> Path:
    """A checkout in ``tmp_path``: a copy of the benchmark with the tiny
    configuration and traffic added as new files, and a BENCHMARK.json of
    the tiny cells."""
    shutil.copytree(REPO / "vcbench", tmp_path / "vcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(FIXTURES / "tiny_v1.json", tmp_path / "vcbench" / "configs" / "tiny_v1.json")
    shutil.copy(FIXTURES / "tiny_offline.json",
                tmp_path / "vcbench" / "traffic" / "tiny_offline.json")
    shutil.copy(FIXTURES / "tiny_xlsr.json", tmp_path / "vcbench" / "configs" / "tiny_xlsr.json")
    for name in ("tiny_stream", "tiny_train"):
        shutil.copy(FIXTURES / f"{name}.json", tmp_path / "vcbench" / "traffic" / f"{name}.json")
    bench = {
        "command": ["python3", "-m", "vcbench"], "paths": ["vcbench"], "run_seconds": 2,
        "configs": [{"name": "tiny_v1", "source": "tests", "file": "vcbench/configs/tiny_v1.json",
                     "reduced": [], "why": "tiny"},
                    {"name": "tiny_xlsr", "source": "tests",
                     "file": "vcbench/configs/tiny_xlsr.json", "reduced": [], "why": "tiny"}],
        "workloads": [
            {"name": "tiny.offline", "config": "tiny_v1", "traffic": "tiny_offline",
             "chips": 1, "why": "tiny"},
            {"name": "tiny.stream", "config": "tiny_xlsr", "traffic": "tiny_stream", "chips": 1,
             "why": "tiny"},
            {"name": "tiny.train", "config": "tiny_v1", "traffic": "tiny_train", "chips": 1,
             "why": "tiny"}],
        "end_to_end": [
            {"name": "audio_s_per_s", "unit": "audio-s/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny.offline"]},
            {"name": "block_p99_ms", "unit": "ms", "better": "lower", "bound": 0.25,
             "source": "host_clock", "workloads": ["tiny.stream"]},
            {"name": "train_frames_per_s", "unit": "frames/s", "better": "higher",
             "bound": 0.25, "source": "host_clock", "workloads": ["tiny.train"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": "convert_mfu.tiny", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "whole step", "moves": "audio_s_per_s",
             "workloads": ["tiny.offline"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(REPO / "vcbench" / "metrics" / "convert_mfu.offline.py",
                tmp_path / "vcbench" / "metrics" / "convert_mfu.tiny.py")
    return tmp_path


def run_cli(root: Path, *args, timeout=600):
    """``python -m vcbench`` in ``root`` on the CPU; (rc, stdout, stderr)."""
    env_path = f"{root}:{REPO}"
    out = subprocess.run([sys.executable, "-m", "vcbench", *args, "--device", "cpu"],
                         cwd=root, capture_output=True, text=True, timeout=timeout,
                         env={**__import__("os").environ, "PYTHONPATH": env_path})
    return out.returncode, out.stdout, out.stderr
