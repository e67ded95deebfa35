"""Two-process dry run of the multi-process replay (``parallel/multihost.py``).

Counterpart of ``tools/dryrun_dcn.py``. Starts two fresh interpreter
processes (never a fork of this one, which may hold a CUDA context),
joins them in a gloo group on a free local port, replays two lanes in
each through ``multihost.replay_global`` and gathers all four lanes'
trajectories in every process. Each worker writes its own report file;
this process merges them into ``--out`` and exits non-zero if a worker
failed, timed out or left no report, or if the workers' gathered arrays
differ.

    python -m loam_velodyne_torch.tools.dryrun_dcn --device cpu --preset tiny --out REPORT.json
    python -m loam_velodyne_torch.tools.dryrun_dcn --device cuda --preset VLP-16 --out REPORT.json

Presets (lane 0 is the same sequence in every process, the probe of
cross-process determinism; lane 1 is the process's own):
- ``tiny``: the JAX dry run's data (``tools/dryrun_dcn.py``): 4 rings of
  512 points, the narrow corridor world, 8 noiseless sweeps, lane 0
  swaying 0.15 m and lane 1 ``0.1 + 0.1 * rank``; chunks of 4, sweeps
  padded to 2,048 rows. The points are rounded to the 1/128 m grid, on
  which the port and the JAX package pick the same features
  (tests/test_torch_multihost.py holds the lanes to the JAX package's).
- ``VLP-16``: the preset at datasheet capacities, 16 sweeps in chunks of
  8 padded to 32,768 rows; lane 0 the bench sequence, lane 1 the noisy
  turning trajectory at the speed and noise seed of chip_smoke.py's
  distinct lanes 1 and 2 (rank 0 and 1).

The report holds, per worker: its rank, device and card, the gathered
positions, each chunk's seconds and the kernels' launches over the
run (their counters, ``ops/lanes.py``: 0 on the CPU, where the plain
versions run); and overall whether the gathered arrays are equal over
the workers and the largest difference between lane 0 of rank 0 and
lane 0 of rank 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from loam_velodyne_torch.config import LidarConfig, LoamConfig
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.ops import (corresp_kernel, greedy_kernel,
                                     grid_kernel, knn_kernel)
from loam_velodyne_torch.parallel import multihost
from loam_velodyne_torch.parallel.replay import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_PROC = 2
LANES_PER_PROC = 2
TINY_QUANTUM = 128
# VLP-16 lane 1 of rank r: chip_smoke.py's distinct lane 1 + r.
LANE1_SEEDS = (101, 102)
LANE1_SPEEDS = (0.5, 0.75)


class Case(NamedTuple):
    """One process's share of a preset: its config, its lanes (each a
    list of (N_i, 3) float32 sweeps), their ground truths, the chunk and
    the sweep capacity."""
    cfg: LoamConfig
    lanes: list
    gts: list
    chunk: int
    cap: int


def tiny_case(rank: int) -> Case:
    cfg = dataclasses.replace(
        tiny_config(),
        lidar=LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=512),
        capacities=None)
    world = (synthetic.corridor_world(length=40, width=2.5, height=2.5)
             + synthetic.box(6, 6.5, -0.8, -0.4, 0, 2.5)
             + synthetic.box(12, 12.5, 0.4, 0.8, 0, 2.5))

    def lane(sway):
        def traj(t):
            return (np.array([t, sway * np.sin(0.6 * t), 1.2], np.float64),
                    0.04 * np.sin(0.5 * t))
        sweeps, gt, _ = synthetic.generate_sequence(
            8, lidar=cfg.lidar, n_azimuth=512, noise_std=0.0, world=world,
            traj=traj)
        return [(np.round(p * TINY_QUANTUM) / TINY_QUANTUM).astype(np.float32)
                for p in sweeps], gt

    (same, gt_same), (own, gt_own) = lane(0.15), lane(0.1 + 0.1 * rank)
    return Case(cfg, [same, own], [gt_same, gt_own], 4, 2048)


def vlp16_case(rank: int) -> Case:
    cfg = LoamConfig.preset("VLP-16")
    bench, gt_bench = synthetic.bench_sweeps(16, cfg.lidar)
    own, gt_own = synthetic.noisy_turning(16, cfg.lidar, LANE1_SEEDS[rank],
                                          LANE1_SPEEDS[rank])
    return Case(cfg, [bench, own], [gt_bench, gt_own], 8, 32768)


CASES = {"tiny": tiny_case, "VLP-16": vlp16_case}


def worker(rank: int, port: int, device: str, preset: str, report: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"grid_windows": grid_kernel.grid_windows,
                "greedy_pick_rows": greedy_kernel.greedy_pick_rows,
                "corresp_search": corresp_kernel.corresp_search,
                "grouped_window_knn": knn_kernel.grouped_window_knn}
    if device == "cpu":
        # Two processes share the host, and the tiny shapes' operations
        # run faster on one thread each than contending for all cores.
        torch.set_num_threads(1)
    case = CASES[preset](rank)
    multihost.init(f"localhost:{port}", N_PROC, rank)
    dev = multihost.default_device() if device == "cuda" else torch.device(device)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    secs = []
    positions = multihost.replay_global(case.cfg, case.lanes, chunk=case.chunk,
                                        sweep_capacity=case.cap, device=dev,
                                        chunk_seconds=secs)
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    t = len(case.lanes[0])
    if positions.shape != (N_PROC * LANES_PER_PROC, t, 3):
        raise AssertionError(f"gathered positions of shape {positions.shape}")
    if not np.isfinite(positions).all():
        raise AssertionError("gathered positions not finite")
    out = {"rank": rank, "device": str(dev),
           "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "preset": preset, "lanes": LANES_PER_PROC, "sweeps": t,
           "chunk": case.chunk, "sweep_capacity": case.cap,
           "positions": positions.tolist(), "chunk_seconds": secs,
           "seconds": seconds, "launches": launches}
    with open(report + ".part", "w") as f:
        json.dump(out, f)
    os.replace(report + ".part", report)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def merge(reports: list) -> dict:
    """The workers' reports and the readings across them."""
    pos = [np.asarray(r["positions"], np.float32) for r in reports]
    lane0 = [pos[0][r * LANES_PER_PROC] for r in range(len(pos))]
    return {"processes": len(reports), "lanes": int(pos[0].shape[0]),
            "sweeps": int(pos[0].shape[1]),
            "gathered_equal": all(np.array_equal(pos[0], p) for p in pos[1:]),
            "lane0_max_abs_diff": float(max(np.abs(l - lane0[0]).max()
                                            for l in lane0[1:])),
            "workers": reports}


def run(device: str, preset: str, out: str, timeout: float = 900.0) -> int:
    """Start the two workers, wait for both (killing them at
    ``timeout`` seconds), merge their reports into ``out``. Returns the
    exit code."""
    out = os.path.abspath(out)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    paths = [f"{out}.rank{r}" for r in range(N_PROC)]
    for p in paths:
        for suffix in ("", ".log"):
            if os.path.exists(p + suffix):
                os.remove(p + suffix)
    t0 = time.perf_counter()
    procs = []
    for rank, path in enumerate(paths):
        with open(path + ".log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "loam_velodyne_torch.tools.dryrun_dcn",
                 "--worker", str(rank), str(port), "--device", device,
                 "--preset", preset, "--out", path],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env))
    failed = []
    deadline = time.monotonic() + timeout
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            failed.append(f"worker {rank} timed out after {timeout} s")
            break
    for rank, p in enumerate(procs):
        if p.returncode != 0 or not os.path.exists(paths[rank]):
            failed.append(f"worker {rank} exited {p.returncode}")
            sys.stderr.write(f"--- worker {rank} rc={p.returncode}\n"
                             f"{_tail(paths[rank] + '.log')}\n")
    if failed:
        sys.stderr.write("dryrun_dcn: " + "; ".join(failed) + "\n")
        return 1
    reports = []
    for path in paths:
        with open(path) as f:
            reports.append(json.load(f))
        os.remove(path)
        os.remove(path + ".log")
    merged = {"ok": False, "device": device, "preset": preset,
              "seconds": time.perf_counter() - t0, **merge(reports)}
    merged["ok"] = merged["gathered_equal"]
    with open(out, "w") as f:
        json.dump(merged, f)
    print(f"dryrun_dcn: {merged['processes']} processes, {merged['lanes']} "
          f"lanes x {merged['sweeps']} sweeps on {device}; gathered arrays "
          f"equal: {merged['gathered_equal']}; lane 0 of each rank apart by "
          f"{merged['lane0_max_abs_diff']:.3g}; {merged['seconds']:.1f} s; "
          f"report {out}", flush=True)
    if not merged["ok"]:
        sys.stderr.write("dryrun_dcn: the workers gathered different arrays\n")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--preset", choices=tuple(CASES), default="VLP-16")
    ap.add_argument("--out", required=True, help="the merged report (JSON)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--worker", nargs=2, type=int, metavar=("RANK", "PORT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker[0], args.worker[1], args.device, args.preset,
               args.out)
        return 0
    return run(args.device, args.preset, args.out, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
