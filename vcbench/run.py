"""Run one cell of ``BENCHMARK.json`` once and print its result line.

``python -m vcbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

1. set-up: build the program from the configuration, fill its weights from
   the seed, make the traffic's audio, warm every shape the traffic uses
   (``setup_s`` runs from process start to the window's opening);
2. the window: the cell's driver drives the program for ``--seconds``;
   with ``--trace 1`` a short sub-window of it runs under the profiler and
   the rest with synchronised stages, for the per-layer metrics;
3. the check, once the window has closed and the program is freed: the
   frozen reference over a sample of the window's requests, each number
   compared printed beside its limit.

The last line of standard output is one JSON object; the numbers compared
are also the last lines of standard error. Exits 3 without a CUDA device
(``--device cpu`` is for the tests alone), 4 if jax, flax or the JAX
package was loaded, and 1 on any other error, printing no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "seedvc_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``seedvc_tpu_torch`` is not ``seedvc_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Run:
    """What a driver and the metric readers see of one run."""

    def __init__(self, args, cell, device, started: float):
        self.args = args
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.device = device
        self.started = started
        self.records: dict = {}     # the driver's, for the readers
        self.subwindow: dict | None = None   # trace.reduce's result
        self.power_limit = None

    def log(self, msg: str) -> None:
        print(f"[vcbench {time.perf_counter() - self.started:7.1f}s] {msg}", file=sys.stderr,
              flush=True)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m vcbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default="0", choices=["0", "1"])
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)  # tests: cpu
    return p.parse_args(argv)


def main(argv, started: float | None = None, root: Path | None = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    root = Path.cwd() if root is None else root
    cache_env(root)
    import torch

    from vcbench import spec

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("vcbench: no CUDA device; no result", file=sys.stderr)
            return 3
    cell = spec.load_cell(root, args.workload)
    if args.device == "cuda" and torch.cuda.device_count() < cell.chips:
        print(f"vcbench: {cell.name} needs {cell.chips} cards, have "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    device = torch.device(args.device)
    run = Run(args, cell, device, started)
    drv = spec.driver(cell.traffic, cell.base)
    bld = spec.builder(cell.config, cell.base)
    run.log(f"{cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, "
            f"seed {run.seed}, {run.seconds:g} s, trace {int(run.trace)}")
    state = drv.setup(run, bld)
    setup_s = time.perf_counter() - started
    run.log(f"set-up {setup_s:.2f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv.window(run, state)
    e2e = drv.end_to_end(run, state)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if device.type == "cuda" else 0}
    if device.type == "cuda":
        run.power_limit = power_limit()
        run.log(f"card: {run.power_limit}")
        dev["power_limit"] = run.power_limit
    if run.trace:
        sub = run.subwindow
        if not sub or (device.type == "cuda" and sub["busy_s"] <= 0):
            print("vcbench: the traced sub-window saw no device operation; no result",
                  file=sys.stderr)
            return 1
        dev["busy_s"], dev["window_s"] = sub["busy_s"], sub["window_s"]
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.base)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is None:
                print(f"vcbench: the driver gave no {m['name']}; no result", file=sys.stderr)
                return 1
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = drv.counts(run, state)
    checks = drv.check(run, state, bld)
    found = forbidden_modules()
    if found:
        print(f"vcbench: loaded {', '.join(found)}: the benchmark may load neither JAX "
              "nor the JAX package; no result", file=sys.stderr)
        return 4
    correct = failed == 0 and all(limit is not None and value <= limit
                                  for value, limit in checks.values())
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if run.trace:
        line["breakdown"] = {"device_ops": run.subwindow["device_ops"],
                             "idle_gaps": run.subwindow["idle_gaps"]}
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r}) "
              f"{'ok' if lim is not None and v <= lim else 'FAILED'}", file=sys.stderr)
    print(f"correct: {correct} (attempted {attempted}, failed {failed})", file=sys.stderr,
          flush=True)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0
