"""What a run is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell
names a configuration (its ``file``), a traffic mix and its chips. The
harness finds the rest by those names, so a cell, a configuration, a
traffic mix or a per-layer metric is added by adding files:

- ``loam_bench/traffic/<traffic>.json``: the mix's parameters, read by
  the one generator (``traffic.py``) and run through the entry that its
  ``"entry"`` names;
- ``loam_bench/entries/<entry>.py``: a way of driving the system (its
  ``ENTRY`` class, built on ``entry.py``);
- ``loam_bench/workloads/<cell>.json``: the cell's check, the samples it
  compares (``sample``) and the limit of each number compared;
- ``loam_bench/metrics/<metric>.py``: the reader of one per-layer metric,
  a function ``read(r)`` of the run's readings that returns a number or
  None.

``plan`` resolves one cell and refuses a missing piece before anything
runs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str] = None
    layer: Optional[str] = None
    read: Optional[Callable] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    entry: Optional[type] = None


_modules: dict = {}


def _load(path: str, prefix: str):
    """The module of a file found by name, loaded once a process."""
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(
            prefix + os.path.basename(path)[:-3].replace(".", "_")
            .replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def _load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_reader(path: str) -> Callable:
    """The ``read`` function of a metric's reader file."""
    return _load(path, "loam_bench_metric_").read


def load_entry(path: str) -> type:
    """The ``ENTRY`` class of an entry's file."""
    return _load(path, "loam_bench_entry_").ENTRY


def _applies(entry: dict, cell: str, cell_e2e: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in cell_e2e


def plan(workload: str, root: str = ROOT,
         bench_dir: Optional[str] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic, check and metrics (readers loaded).
    ``bench_dir``: where the traffic, workloads and metrics folders are
    (this package's folder by default)."""
    bench_dir = bench_dir or HERE
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    check = _load_json(os.path.join(bench_dir, "workloads",
                                    workload + ".json"))
    entry_path = os.path.join(bench_dir, "entries", traffic["entry"] + ".py")
    if not os.path.isfile(entry_path):
        raise FileNotFoundError(
            f"missing the entry {os.path.relpath(entry_path, root)}")
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"])
           for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m.name for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if not _applies(m, workload, names):
            continue
        path = os.path.join(bench_dir, "metrics", m["name"] + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"missing the reader {os.path.relpath(path, root)}")
        per_layer.append(Metric(m["name"], m["unit"], m["better"],
                                m["source"], m["moves"], m["layer"],
                                load_reader(path)))
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, check, e2e, per_layer, load_entry(entry_path))
