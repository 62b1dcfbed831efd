"""What a run is about, found by name: ``BENCHMARK.json`` at the root of the
checkout, a configuration's file under ``perfbench/configs/``, a traffic mix's under
``perfbench/traffic/``, a metric's reader under ``perfbench/metrics/`` and a cell's
limits under ``perfbench/checks/``.  A later change adds a cell by adding such files
and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]        # perfbench/
ROOT = BENCH.parent                                # the checkout


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(BENCH / "checks" / f"{workload_name}.json")


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones with ``trace`` off, its per-layer ones
    with it on; a metric with a ``workloads`` key only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload_name in m.get("workloads", [workload_name])]


def reader(metric_name: str) -> ModuleType:
    """The metric's reader, ``perfbench/metrics/<name>.py``: a module with
    ``read(run) -> float | None``."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(bench: dict, workload_name: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics, by name."""
    cell = workload(bench, workload_name)
    return {"cell": cell, "cfg": config(bench, cell["config"]),
            "traffic": traffic(cell["traffic"]), "limits": limits(workload_name),
            "metrics": {trace: metrics_for(bench, workload_name, trace)
                        for trace in (False, True)}}


def runner(traffic_mix: dict) -> ModuleType:
    """The module that runs a cell of this traffic's kind: ``harness/<kind>_cell.py``."""
    return importlib.import_module(f"harness.{traffic_mix['kind']}_cell")


def reference(cfg: dict) -> ModuleType:
    """The configuration's plain reference: ``harness/<cfg["reference"]>.py``."""
    return importlib.import_module(f"harness.{cfg['reference']}")
