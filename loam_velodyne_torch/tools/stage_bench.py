"""Per-stage times of the real sweep step: ingest+features, odometry, mapping.

    python -m loam_velodyne_torch.tools.stage_bench [preset=HDL-64E] [--sized] \\
        [--set key=value ...] [--device cuda]

Counterpart of ``tools/stage_bench.py``, by its method: the fused
ingest+features alone, then ``engine.step`` with mapping "on" and "off"
(the static GN schedules) over 8 distinct sweeps, each call from one
frozen warm state. The state is warmed on the io_ratio cadence over 16
sweeps, so the GN loops do real work (a step fed its own last cloud
converges in one iteration); it is frozen because a state that evolves
drifts the on and off runs into different iteration counts. Then

    odometry = step (mapping off) - ingest+features
    mapping  = step (mapping on) - step (mapping off), a mapping frame

Each timing runs one call first, then REPS calls ending in one
``torch.cuda.synchronize()``. ``--sized`` sizes the preset to the
stream (``bench.sized``); otherwise its datasheet capacities hold.
"""

from __future__ import annotations

import argparse
import time

import torch

from loam_velodyne_torch import bench
from loam_velodyne_torch.config import LoamConfig, apply_overrides
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models.engine import require_device, sync
from loam_velodyne_torch.ops import scan as scan_mod
from loam_velodyne_torch.ops.features import extract_features
from loam_velodyne_torch.ops.scan import RawSweep

N_SWEEPS = 8
REPS = 30


def timeit(fn, inputs: list, label: str, device: torch.device) -> float:
    """Mean seconds of ``fn`` over REPS calls cycling through ``inputs``
    (after one call), printed as the JAX tool prints it."""
    fn(*inputs[0])
    sync(device)
    t0 = time.perf_counter()
    for i in range(REPS):
        fn(*inputs[i % len(inputs)])
    sync(device)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{label:34s} {dt * 1e3:8.3f} ms", flush=True)
    return dt


def stage_times(cfg: LoamConfig, raws: list, device) -> dict:
    """Time the stages over ``raws`` (RawSweeps on ``device``) and print
    them with the derived odometry, mapping and amortized lines;
    returns the three measured means in seconds."""
    device = require_device(device)

    def feat(raw):
        grid, _ = scan_mod.ingest_sweep(raw, cfg.lidar, cfg.registration)
        return extract_features(grid, cfg.registration, cfg.capacities)

    t_feat = timeit(feat, [(r,) for r in raws], "ingest+features", device)

    io = cfg.odometry.io_ratio
    state, cadence = engine_mod.EngineState.create(cfg, device), engine_mod.Cadence()
    for k in range(2 * len(raws)):
        mode = "on" if k % io == 1 else "off"
        state, _ = engine_mod.step(state, raws[k % len(raws)], cfg, mode,
                                   cadence, static_schedule=True)
        cadence = cadence.advance(cfg)

    def step(mode):
        return lambda raw: engine_mod.step(state, raw, cfg, mode, cadence,
                                           static_schedule=True)

    t_off = timeit(step("off"), [(r,) for r in raws], "step (mapping off)",
                   device)
    t_on = timeit(step("on"), [(r,) for r in raws], "step (mapping on)", device)
    print(f"{'-> odometry (off - feat)':34s} {1e3 * (t_off - t_feat):8.3f} ms")
    print(f"{'-> mapping increment':34s} {1e3 * (t_on - t_off):8.3f} ms")
    print(f"{'-> amortized/sweep @io_ratio':34s} "
          f"{1e3 * (t_off + (t_on - t_off) / io):8.3f} ms", flush=True)
    return {"ingest_features_s": t_feat, "step_off_s": t_off, "step_on_s": t_on}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m loam_velodyne_torch.tools.stage_bench")
    p.add_argument("preset", nargs="?", default="HDL-64E")
    p.add_argument("--sized", action="store_true",
                   help="size the preset to the stream (bench.sized)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    cfg = apply_overrides(LoamConfig.preset(args.preset), args.set)
    sweeps, _ = synthetic.bench_sweeps(N_SWEEPS, cfg.lidar)
    if args.sized:
        cfg, cap = bench.sized(cfg, sweeps)
    else:
        cap = cfg.capacities.full_cloud
    print(f"{args.preset}: input N={cap}, ring P={cfg.lidar.max_points_per_ring}")
    xyz, mask = synthetic.pad_sweeps(sweeps, cap)
    xyz, mask = torch.from_numpy(xyz).to(device), torch.from_numpy(mask).to(device)
    return stage_times(cfg, [RawSweep(x, m) for x, m in zip(xyz, mask)], device)


if __name__ == "__main__":
    main()
