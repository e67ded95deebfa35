"""Smoke run of the PyTorch port on one CUDA card.

Builds the four CUDA kernels of ``loam_velodyne_torch`` from the sources
in this checkout, compares each with its plain PyTorch version at every
VLP-16 main-path shape and times it there (the wrapper, its device work
in a CUDA graph, the plain version, a library call where one computes
the same function, and the bound from
``loam_velodyne_torch/tools/kernel_times.py``),
then replays the 48-sweep synthetic benchmark sequence (noisy turning
trajectory) through the engine's static-cadence chunks on ``cuda:0`` and
checks the trajectory, the telemetry and each kernel's launch count.
The replay records the arguments of each K2 call on the way to the
wrapper; after it, each of those calls is held against the plain
version, and the steps its rows need and its time in a CUDA graph
go under ``engine`` in K2's row (K2's time follows its data). Beside
the kernels it times an empty kernel launched the same way, in a
CUDA graph: the launch floor, the least time any launch takes on the
card, printed on its own line and as ``floor_ms``. It imports only
``loam_velodyne_torch`` (never JAX or the JAX package).

Run from the repository root:  python3 chip_smoke.py
Every failure raises (non-zero exit). The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it is the card's
``name, power.limit``, and before that one JSON object with each
kernel's launches, error, times and bound, the heaviest main-path case
at the top level and every case under ``cases``, and the launch floor.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.eval.metrics import ate_rmse
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models.engine import Engine
from loam_velodyne_torch.ops import (corresp_kernel, cuda_lib, features,
                                     greedy_kernel, grid_kernel, knn_kernel)
from loam_velodyne_torch.tools import kernel_times

SEED = 0
N_SWEEPS = 48
CHUNK = 8
SWEEP_CAP = 32768
ATE_GATE_M = 0.05


def _nvcc_version() -> str:
    out = subprocess.run([cuda_lib.nvcc(), "--version"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def replay(engine: Engine, xyz: torch.Tensor, mask: torch.Tensor):
    """Run the sequence through the engine in chunks of CHUNK sweeps.
    Returns the (n, 29) packed outputs and the host time at which the
    first chunk had finished on the device."""
    packed, t_first = [], None
    for s in range(0, xyz.shape[0], CHUNK):
        packed.append(engine.run_chunk(xyz[s:s + CHUNK], mask[s:s + CHUNK]).packed)
        if t_first is None:
            _sync(engine.device)
            t_first = time.perf_counter()
    _sync(engine.device)
    return torch.cat(packed), t_first


def _max_abs_err(a, b) -> float:
    a, b = a.double(), b.double()
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
    d = torch.where(both_inf, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def _require_equal(name: str, got, want) -> float:
    """Integer outputs must match exactly; float outputs too (every
    kernel computes the same float32 operations in the same order as
    its plain version). Returns the max abs error of float outputs."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: shape/dtype {g.shape} {g.dtype} "
                                 f"vs {w.shape} {w.dtype}")
        if g.dtype.is_floating_point:
            e = _max_abs_err(g, w)
            err = max(err, e)
            if e != 0.0:
                raise AssertionError(f"{name}: float output differs by {e}")
        elif not torch.equal(g, w):
            n = int((g != w).sum())
            raise AssertionError(f"{name}: {n} integer outputs differ")
    return err


# name -> (wrapper, plain version, source, the TPU kernel it replaces,
# its main-path cases, the case whose numbers head its row)
KERNELS = {
    "grid_windows": (
        grid_kernel.grid_windows, grid_kernel.grid_windows_plain,
        "loam_velodyne_torch/csrc/grid.cu",
        "loam_velodyne_tpu/ops/pallas_grid.py:56", ("grid",), "grid"),
    "greedy_pick_rows": (
        greedy_kernel.greedy_pick_rows, greedy_kernel.greedy_pick_rows_plain,
        "loam_velodyne_torch/csrc/greedy.cu",
        "loam_velodyne_tpu/ops/pallas_greedy.py:90",
        ("greedy_corner", "greedy_flat"), "greedy_corner"),
    "corresp_search": (
        corresp_kernel.corresp_search, corresp_kernel.corresp_search_plain,
        "loam_velodyne_torch/csrc/corresp.cu",
        "loam_velodyne_tpu/ops/pallas_corresp.py:137",
        ("corresp_corner", "corresp_surf"), "corresp_surf"),
    "grouped_window_knn": (
        knn_kernel.grouped_window_knn, knn_kernel.grouped_window_knn_plain,
        "loam_velodyne_torch/csrc/knn.cu",
        "loam_velodyne_tpu/ops/pallas_knn.py:59",
        ("knn_corner", "knn_surf"), "knn_surf"),
}
# Launches of each kernel in the 48-sweep replay: K1 once and K2 twice
# per sweep, K3 10 times per odometry sweep (47), K4 10 times per
# mapping frame (24).
EXPECTED_LAUNCHES = {"grid_windows": 48, "greedy_pick_rows": 96,
                     "corresp_search": 470, "grouped_window_knn": 240}


def _library_call(case: str, args: tuple):
    """One PyTorch call that computes the same function (timed as a
    yardstick, never called by the port), or None where there is none."""
    if case == "grid":
        cols, starts, p = args
        return lambda: torch.index_select(cols.unfold(1, p, 1), 1, starts)
    return None


def check_kernels(dev) -> list[dict]:
    """Each kernel against its plain version on the card at every
    main-path shape (inputs from a numpy seed), then timed: the wrapper
    and the plain version by CUDA events around back-to-back calls
    (``ms``, ``plain_ms``: what a caller pays, host time included); the
    wrapper and the library call captured in a CUDA graph, which replays
    only their device work (``kernel_ms``, ``library_ms``: the device's
    time with the host out of the way); the host's time to enqueue a
    wrapper call (``host_ms``); the wrapper's device operations per call
    and their summed durations (``device_ms``, from the profiler); beside
    the bound computed from the same inputs."""
    inputs = kernel_times.main_path_inputs(dev, SEED)
    rows = []
    for name, (wrapper, plain, source, replaces, cases, head) in KERNELS.items():
        per_case, err = {}, 0.0
        for case in cases:
            args = inputs[case]
            got = wrapper(*args)
            want = plain(*args)
            got, want = ((got,), (want,)) if name == "grid_windows" else (got, want)
            err = max(err, _require_equal(f"{name} {case}", got, want))
            k_fn, l_fn = (lambda: wrapper(*args)), _library_call(case, args)
            if l_fn is not None:
                _require_equal(f"{name} {case} library call",
                               (l_fn().permute(1, 0, 2),), got)
            ms = kernel_times.time_ms(k_fn)
            kernel_ms = kernel_times.graph_ms(k_fn)
            plain_ms = kernel_times.time_ms(lambda: plain(*args))
            library_ms = None if l_fn is None else kernel_times.graph_ms(l_fn)
            kernel_ms = min(kernel_ms, kernel_times.graph_ms(k_fn))
            ms = min(ms, kernel_times.time_ms(k_fn))
            per_case[case] = {
                "shapes": [list(a.shape) for a in args
                           if isinstance(a, torch.Tensor)],
                "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "host_ms": kernel_times.host_ms(k_fn),
                **kernel_times.device_profile(k_fn),
                **kernel_times.bound(case, args)}
            if name == "greedy_pick_rows":
                steps = greedy_kernel.greedy_chain_steps(*args)
                per_case[case]["chain_steps"] = {
                    "longest_row": int(steps.max()),
                    "median_row": float(steps.float().median())}
            c = per_case[case]
            print(f"kernel {name} {case}: exact match; wrapper {ms:.4f} ms, "
                  f"in a graph {kernel_ms:.4f} ms, host "
                  f"{c['host_ms']:.4f} ms, "
                  f"on the device "
                  f"{c['device_ms']:.4f} ms in {c['device_ops_per_call']:g} "
                  f"operations, plain {plain_ms:.4f} ms, library "
                  f"{library_ms}, bound {c['bound_ms']:.6f} ms "
                  f"({c['bound_by']})", flush=True)
        h = per_case[head]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err,
                     **{k: h[k] for k in ("ms", "kernel_ms", "device_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
                     "cases": per_case})
    return rows


def launch_floor(dev) -> float:
    """The empty kernel's time per call in a CUDA graph (ms)."""
    floor_ms = min(kernel_times.graph_ms(lambda: cuda_lib.noop(dev))
                   for _ in range(2))
    print(f"launch floor: {floor_ms:.4f} ms per empty kernel in a graph",
          flush=True)
    return floor_ms


def engine_greedy(calls: list) -> dict:
    """K2 on the inputs the engine gave it in the replay, for corners and
    for flats: each call against the plain version, the steps each row
    needs (``greedy_chain_steps``: ``longest_row`` over all calls, the
    median call's longest row, the median row; the chain runs them
    rounded up to a group of 8) and each call's time in a CUDA graph
    (mean and max)."""
    out = {}
    for kind, corner in (("corner", True), ("flat", False)):
        mine = [a for a in calls if a[9] is corner]
        for i, a in enumerate(mine):
            _require_equal(f"greedy_pick_rows engine {kind} call {i}",
                           greedy_kernel.greedy_pick_rows(*a),
                           greedy_kernel.greedy_pick_rows_plain(*a))
        steps = torch.stack([greedy_kernel.greedy_chain_steps(*a)
                             for a in mine]).float()
        ms = [kernel_times.graph_ms(
                  lambda a=a: greedy_kernel.greedy_pick_rows(*a), 10, 5)
              for a in mine]
        out[kind] = {"calls": len(mine), "shape": list(mine[0][0].shape),
                     "longest_row": int(steps.max()),
                     "median_call_longest_row":
                         float(steps.max(1).values.median()),
                     "median_row": float(steps.median()),
                     "kernel_ms_mean": sum(ms) / len(ms),
                     "kernel_ms_max": max(ms)}
        o = out[kind]
        print(f"engine K2 {kind}: {o['calls']} calls of {o['shape']}, bit-equal "
              f"to the plain version; rows need up to {o['longest_row']} "
              f"steps (median call {o['median_call_longest_row']:g}, median row "
              f"{o['median_row']:g}); in a graph {o['kernel_ms_mean']:.4f} ms "
              f"a call (max {o['kernel_ms_max']:.4f})", flush=True)
    return out


def run_engine(dev, card: str) -> tuple[dict, list]:
    """Replay the benchmark sequence through the port's engine. Returns
    the kernels' launch counts and K2's calls (their arguments), which
    the replay records on the way to the wrapper."""
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, gt = synthetic.bench_sequence(N_SWEEPS, cfg.lidar, SWEEP_CAP)
    xyz_d = torch.from_numpy(xyz).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    engine = Engine(cfg, dev)
    wrappers = {"grid_windows": grid_kernel.grid_windows,
                "greedy_pick_rows": greedy_kernel.greedy_pick_rows,
                "corresp_search": corresp_kernel.corresp_search,
                "grouped_window_knn": knn_kernel.grouped_window_knn}
    for fn in wrappers.values():
        fn.launches = 0
    greedy_calls = []

    def recorded_greedy(*args):
        greedy_calls.append(args)
        return greedy_kernel.greedy_pick_rows(*args)

    features.greedy_pick_rows = recorded_greedy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        packed, t_first = replay(engine, xyz_d, mask_d)
    finally:
        features.greedy_pick_rows = greedy_kernel.greedy_pick_rows
    t_end = time.perf_counter()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"engine kernel launches: {json.dumps(launches)}", flush=True)
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{EXPECTED_LAUNCHES}")

    packed = packed.cpu().numpy()
    if packed.shape != (N_SWEEPS, 29) or not np.isfinite(packed).all():
        raise AssertionError("engine outputs not finite or of the wrong shape")
    counters = packed[:, 20:28]
    if (counters != 0).any():
        raise AssertionError(f"telemetry counters not zero: {counters.sum(0)}")
    ate = ate_rmse(packed[:, 15:18], gt, align=True)
    total_s = t_end - t0
    steady_s = t_end - t_first
    rate = N_SWEEPS / total_s
    steady_rate = (N_SWEEPS - CHUNK) / steady_s
    print(f"engine: {N_SWEEPS} sweeps, ATE {ate * 100:.3f} cm, "
          f"{rate:.2f} sweeps/s ({1000 / rate:.2f} ms/sweep) over all chunks, "
          f"{steady_rate:.2f} sweeps/s ({1000 / steady_rate:.2f} ms/sweep) "
          f"after the first chunk, card: {card}", flush=True)
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"ATE {ate:.4f} m above the {ATE_GATE_M} m gate")
    return launches, greedy_calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = kernel_times.card()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {_nvcc_version()}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda:0")
    floor_ms = launch_floor(dev)
    kernels = check_kernels(dev)
    launches, greedy_calls = run_engine(dev, card)
    for row in kernels:
        if row["name"] == "greedy_pick_rows":
            row["engine"] = engine_greedy(greedy_calls)
        row["launches"] = launches[row["name"]]
        row["launches_per_sweep"] = launches[row["name"]] / N_SWEEPS
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
