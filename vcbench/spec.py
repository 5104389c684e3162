"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the configuration's file
names its builder, the traffic file its driver, and each per-layer metric is
``metrics/<metric name>.py``. Nothing here lists a cell, a configuration or a
metric: a later change adds one by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict          # the configuration file's contents
    traffic_name: str
    traffic: dict         # the traffic file's contents
    end_to_end: list      # BENCHMARK.json entries this cell reports (--trace 0)
    per_layer: list       # the same for --trace 1
    chips: int
    base: Path            # the benchmark's folder in this checkout


def load_module(path: Path, name: str) -> ModuleType:
    """Import one file by its path (metric names hold dots, so no import
    statement reaches them)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its configuration
    and traffic read from the checkout ``root``."""
    base = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
                chips=int(w["chips"]), base=base)


def builder(config: dict, base: Path) -> ModuleType:
    return load_module(base / "builders" / f"{config['builder']}.py",
                       f"vcbench.builders.{config['builder']}")


def driver(traffic: dict, base: Path) -> ModuleType:
    return load_module(base / "drivers" / f"{traffic['driver']}.py",
                       f"vcbench.drivers.{traffic['driver']}")


def metric_reader(name: str, base: Path):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return load_module(base / "metrics" / f"{name}.py",
                       "vcbench.metrics." + name.replace(".", "_")).read
