"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration is ``configs/<config>.json`` (the ``file`` of its entry), the
traffic mix ``traffic/<traffic>.json``, whose ``kind`` names the driver
``drivers/<kind>.py``.  Each metric is read by ``metrics/<metric>.py``, and
the limits of the numbers that decide ``correct`` are
``limits/<workload>.json``.  Adding a configuration, a mix, a driver, a
metric or a cell adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = BENCH.parent  # the checkout


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its name
    traffic: dict  # the traffic mix's file, with its name
    limits: dict  # number -> {"limit": ..., ...}
    end_to_end: tuple  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The module at ``path``, loaded under ``name`` (a metric's file name
    holds dots, so it is loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every cell, or those its
    ``workloads`` lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json``, with its files."""
    spec = benchmark(root)
    entry = {w["name"]: w for w in spec["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return make_cell(name, entry["config"], entry["traffic"], int(entry["chips"]), root)


def make_cell(name: str, config: str, traffic: str, chips: int = 1, root: Path = ROOT) -> Cell:
    """A cell of ``configs/<config>.json`` under ``traffic/<traffic>.json``,
    with the limits of ``limits/<name>.json`` and the metrics that
    ``BENCHMARK.json`` has it report; also for a cell it does not list."""
    spec = benchmark(root)
    files = {c["name"]: c["file"] for c in spec["configs"]}
    conf = files.get(config, f"benchmark/configs/{config}.json")
    return Cell(name, chips, {"name": config, **_json(root / conf)},
                {"name": traffic, **_json(root / "benchmark" / "traffic" / f"{traffic}.json")},
                _json(root / "benchmark" / "limits" / f"{name}.json"),
                tuple(m for m in spec["end_to_end"] if reports(m, name)),
                tuple(m for m in spec["per_layer"] if reports(m, name)))


def driver(kind: str) -> ModuleType:
    return load_module(BENCH / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")


def metric(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))
