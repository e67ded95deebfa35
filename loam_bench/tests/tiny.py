"""A small cell for the CPU tests: the benchmark's own ``BENCHMARK.json``
with its cells and configurations swapped for one cell of the ``vlp16``
configuration with a few lanes and short drives, written into a temporary
checkout, held to the ``vlp16`` cells' own limits."""

from __future__ import annotations

import json
import os
import shutil

from loam_bench import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = {"yaw_rate": 0.05, "yaw_rate_spread": 0.4, "sway_freq": 0.15,
          "sway_freq_step": 0.02}
# Two lanes whose sway differs as much as the halves of the cells' eight
# lanes do (0.15-0.21 Hz against 0.23-0.29 Hz), so that a lane given the
# other's outputs moves visibly apart from its own sweeps.
RECIPE_APART = dict(RECIPE, sway_freq_step=0.14)
TRAFFIC = {
    "batched_chunk": {"entry": "batched_chunk", "lanes": 2, "chunk": 4,
                      "drive_sweeps": 16, "bag_sweeps": 8,
                      "world_length_m": 30.0, "lane_recipe": RECIPE_APART,
                      "warm_calls": 1, "trace_steps": 4},
    "live": {"entry": "live", "lanes": 1, "drive_sweeps": 40,
             "bag_sweeps": 40, "world_length_m": 30.0, "lane_recipe": RECIPE,
             "warm_calls": 2, "trace_steps": 4},
}
with open(os.path.join(HERE, "workloads", "vlp16-live.json")) as f:
    LIMITS = json.load(f)["limits"]
CHECK = {"sample": {"start_sweeps": 4, "starts": 1, "odometry": 4,
                    "boundary": 1},
         "limits": LIMITS}


def tiny_config() -> dict:
    """The ``vlp16`` configuration as the cells run it."""
    with open(os.path.join(HERE, "configs", "vlp16.json")) as f:
        return dict(json.load(f), name="tiny")


def write_cell(root: str, entry: str, cell: str = "tiny-cell") -> str:
    """A checkout under ``root`` holding one tiny cell driven through
    ``entry``; returns the cell's name."""
    bench_dir = os.path.join(root, "loam_bench")
    for d in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(bench_dir, d), exist_ok=True)
    for d in ("metrics", "entries"):
        if not os.path.isdir(os.path.join(bench_dir, d)):
            shutil.copytree(os.path.join(HERE, d), os.path.join(bench_dir, d))
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    with open(os.path.join(bench_dir, "traffic", f"tiny_{entry}.json"),
              "w") as f:
        json.dump(TRAFFIC[entry], f)
    with open(os.path.join(bench_dir, "workloads", f"{cell}.json"), "w") as f:
        json.dump(CHECK, f)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "tiny_config",
                         "file": "loam_bench/configs/tiny.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"] = [{"name": cell, "config": "tiny",
                           "traffic": f"tiny_{entry}", "chips": 1,
                           "why": "CPU tests"}]
    single = ("latency_p95_ms", "driver.host_ms_per_sweep")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ([cell] if entry == "live"
                              or m["name"] not in single else [])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return cell


def plan(root: str, entry: str) -> spec.Cell:
    return spec.plan(write_cell(root, entry), root=root,
                     bench_dir=os.path.join(root, "loam_bench"))
