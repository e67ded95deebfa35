"""Smoke run of the PyTorch port on one CUDA card.

Builds the four CUDA kernels of ``loam_velodyne_torch`` from the sources
in this checkout, compares each with its plain PyTorch version at the
VLP-16 main-path shapes, then replays the 48-sweep synthetic benchmark
sequence (noisy turning trajectory) through the engine's static-cadence
chunks on ``cuda:0`` and checks the trajectory and telemetry. It
imports only ``loam_velodyne_torch`` (never JAX or the JAX package).

Run from the repository root:  python3 chip_smoke.py
Every failure raises (non-zero exit). The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it is the card's
``name, power.limit``, and before that one JSON object with each
kernel's launches, error and times.
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
from loam_velodyne_torch.ops import (corresp_kernel, cuda_lib, greedy_kernel,
                                     grid_kernel, knn_kernel)

SEED = 0
N_SWEEPS = 48
CHUNK = 8
SWEEP_CAP = 32768
ATE_GATE_M = 0.05


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def check_kernels(dev) -> list[dict]:
    """Each kernel against its plain version on the card, at VLP-16
    main-path shapes, inputs from a numpy seed."""
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rows = []

    def record(name, source, replaces, err, k_fn, p_fn):
        ms_k = _time_ms(k_fn)
        ms_p = _time_ms(p_fn)
        ms_k = min(ms_k, _time_ms(k_fn))      # plain, kernel, kernel order
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms_k, "plain_ms": ms_p})
        print(f"kernel {name}: exact match, {ms_k:.4f} ms vs plain "
              f"{ms_p:.4f} ms", flush=True)

    # K1: 16 rings x 4 columns x P=2048 windows of a 32768-row sweep.
    n, p, r = SWEEP_CAP, 2048, 16
    cols = t(rng.normal(size=(4, n + p)).astype(np.float32))
    starts = np.sort(rng.integers(0, n, size=r)).astype(np.int32)
    starts[0], starts[-1] = 0, n
    starts = t(starts)
    got = grid_kernel.grid_windows(cols, starts, p)
    want = grid_kernel.grid_windows_plain(cols, starts, p)
    err = _require_equal("grid_windows", [got], [want])
    record("grid_windows", "loam_velodyne_torch/csrc/grid.cu",
           "loam_velodyne_tpu/ops/pallas_grid.py:56", err,
           lambda: grid_kernel.grid_windows(cols, starts, p),
           lambda: grid_kernel.grid_windows_plain(cols, starts, p))

    # K2: 96 (ring, region) rows x W=384, corner (96 steps) and flat (64).
    rows_n, w = 96, 384
    curv = t(rng.exponential(0.1, size=(rows_n, w)).astype(np.float32))
    picked0 = t(rng.random((rows_n, w)) < 0.1)
    left = t(rng.integers(0, 6, size=(rows_n, w)).astype(np.int32))
    right = t(rng.integers(0, 6, size=(rows_n, w)).astype(np.int32))
    in_region = t(rng.random((rows_n, w)) < 0.9)
    err = 0.0
    for corner, steps, quota, sharp in ((True, 96, 20, 2), (False, 64, 4, 0)):
        scores = torch.where(in_region & ~picked0, curv if corner else -curv,
                             float("-inf"))
        top, cand = torch.sort(scores, dim=1, descending=True, stable=True)
        cand = cand[:, :steps].to(torch.int32).contiguous()
        ok = torch.isfinite(top[:, :steps]).contiguous()
        args = (curv, cand, ok, picked0, left, right, 0.1, quota, sharp, corner)
        got = greedy_kernel.greedy_pick_rows(*args)
        want = greedy_kernel.greedy_pick_rows_plain(*args)
        err = max(err, _require_equal("greedy_pick_rows", got, want))
    record("greedy_pick_rows", "loam_velodyne_torch/csrc/greedy.cu",
           "loam_velodyne_tpu/ops/pallas_greedy.py:90", err,
           lambda: greedy_kernel.greedy_pick_rows(*args),
           lambda: greedy_kernel.greedy_pick_rows_plain(*args))

    # K3: corner (256 vs 2048) and surf (512 vs 8192) searches.
    err = 0.0
    for surf, nq, m in ((False, 256, 2048), (True, 512, 8192)):
        q = t((rng.normal(size=(nq, 3)) * 5).astype(np.float32))
        ref = t((rng.normal(size=(m, 3)) * 5).astype(np.float32))
        ring = t(rng.integers(0, 16, size=m).astype(np.int32))
        mask = rng.random(m) < 0.8
        mask[m // 2:] = False                      # padded tail, as in use
        mask = t(mask)
        got = corresp_kernel.corresp_search(q, ref, ring, mask, 2.5, surf)
        want = corresp_kernel.corresp_search_plain(q, ref, ring, mask, 2.5, surf)
        err = max(err, _require_equal("corresp_search", got, want))
    record("corresp_search", "loam_velodyne_torch/csrc/corresp.cu",
           "loam_velodyne_tpu/ops/pallas_corresp.py:137", err,
           lambda: corresp_kernel.corresp_search(q, ref, ring, mask, 2.5, True),
           lambda: corresp_kernel.corresp_search_plain(q, ref, ring, mask, 2.5,
                                                       True))

    # K4: T=16 (corner stack 2048) and T=32 (surf stack 4096) groups of
    # 128 queries against windows of 1024 sorted map rows.
    err = 0.0
    for tg in (16, 32):
        cloud = (rng.normal(size=(tg * 1024, 3)) * 5).astype(np.float32)
        cloud = cloud[np.argsort(cloud[:, 2], kind="stable")]
        windows = t(cloud.reshape(tg, 1024, 3))
        qg = t((cloud.reshape(tg, 1024, 3)[:, ::8]
                + rng.normal(size=(tg, 128, 3)) * 0.3).astype(np.float32))
        got = knn_kernel.grouped_window_knn(qg, windows, 5)
        want = knn_kernel.grouped_window_knn_plain(qg, windows, 5)
        err = max(err, _require_equal("grouped_window_knn", got, want))
    record("grouped_window_knn", "loam_velodyne_torch/csrc/knn.cu",
           "loam_velodyne_tpu/ops/pallas_knn.py:59", err,
           lambda: knn_kernel.grouped_window_knn(qg, windows, 5),
           lambda: knn_kernel.grouped_window_knn_plain(qg, windows, 5))
    return rows


def run_engine(dev, card: str) -> dict:
    """Replay the benchmark sequence through the port's engine."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed, t_first = replay(engine, xyz_d, mask_d)
    t_end = time.perf_counter()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"engine kernel launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the engine")

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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {_nvcc_version()}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda:0")
    kernels = check_kernels(dev)
    launches = run_engine(dev, card)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
