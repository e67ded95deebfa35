"""Growth as data: a cell, a configuration, a traffic mix, an entry and a
per-layer metric added only as new files (and entries of ``BENCHMARK.json``) are
found by name and planned, with no existing file of the benchmark
edited; and every cell of the committed ``BENCHMARK.json`` plans."""

import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from loam_bench import check, run, spec
from loam_bench.tests import tiny

torch.set_num_threads(1)
ROOT = os.path.dirname(spec.HERE)


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])
def test_every_committed_cell_plans(cell):
    c = spec.plan(cell)
    assert c.name == cell and c.chips == 1
    assert {m.name for m in c.end_to_end} >= {"sweeps_per_s", "setup_s"}
    assert c.per_layer and all(callable(m.read) for m in c.per_layer)
    assert set(c.check["limits"]) == set(check.NUMBERS)
    assert c.entry is not None


def test_a_cell_added_as_files_is_found_and_runs(tmp_path):
    root = str(tmp_path)
    bench_dir = os.path.join(root, "loam_bench")
    for d in ("configs", "traffic", "workloads", "metrics", "entries"):
        shutil.copytree(os.path.join(spec.HERE, d), os.path.join(bench_dir, d))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(bench_dir)

    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(tiny.tiny_config(), f)
    with open(os.path.join(bench_dir, "traffic", "tiny_mix.json"), "w") as f:
        json.dump(dict(tiny.TRAFFIC["batched_chunk"], entry="copied_chunk"), f)
    shutil.copy(os.path.join(bench_dir, "entries", "batched_chunk.py"),
                os.path.join(bench_dir, "entries", "copied_chunk.py"))
    with open(os.path.join(bench_dir, "workloads", "tiny-new.json"), "w") as f:
        json.dump(tiny.CHECK, f)
    with open(os.path.join(bench_dir, "metrics", "window.calls.py"), "w") as f:
        f.write("def read(r):\n    return float(r.window.calls)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tiny_config",
                             "file": "loam_bench/configs/tiny.json",
                             "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({"name": "tiny-new", "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "window.calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "window", "moves": "sweeps_per_s",
                               "workloads": ["tiny-new"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = spec.plan("tiny-new", root=root, bench_dir=bench_dir)
    assert cell.traffic["entry"] == "copied_chunk"
    assert cell.entry.__module__.endswith("copied_chunk")
    assert [m.name for m in cell.per_layer] == ["window.calls"]
    assert [m.name for m in cell.end_to_end] == ["sweeps_per_s", "setup_s"]
    out = run.run_cell(cell, 2 ** 31 + 5, 0.5, True, "cpu", time.time())
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["window.calls"]["value"] >= 1
    after = _digests(bench_dir)
    assert all(after[k] == v for k, v in before.items())


def test_a_missing_piece_is_refused_before_anything_runs(tmp_path):
    root = str(tmp_path)
    name = tiny.write_cell(root, "live")
    os.remove(os.path.join(root, "loam_bench", "workloads", f"{name}.json"))
    with pytest.raises(FileNotFoundError):
        spec.plan(name, root=root, bench_dir=os.path.join(root, "loam_bench"))
