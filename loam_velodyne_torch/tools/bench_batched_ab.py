"""The batched replay's two rates for one config, without the rest of the bench:

    python -m loam_velodyne_torch.tools.bench_batched_ab [preset=VLP-16] \\
        [n_sweeps=48] [batch=8] [--set key=value ...] [--device cuda]

Counterpart of ``tools/bench_batched_ab.py``: ``bench.bench_batched``
(identical lanes of the preset's noisy turning sequence) and
``bench.bench_batched_distinct`` (the bench's distinct VLP-16 lanes),
both at the preset's datasheet capacities. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

from loam_velodyne_torch import bench
from loam_velodyne_torch.config import LoamConfig, apply_overrides
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models.engine import require_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m loam_velodyne_torch.tools.bench_batched_ab")
    p.add_argument("preset", nargs="?", default="VLP-16")
    p.add_argument("n_sweeps", nargs="?", type=int, default=48)
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        bench.require_timed_chunk(args.n_sweeps)
    except ValueError as e:
        p.error(str(e))
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = require_device(args.device)
    cfg = apply_overrides(LoamConfig.preset(args.preset), args.set)
    sweeps, _ = synthetic.bench_sweeps(args.n_sweeps, cfg.lidar)
    cap = cfg.capacities.full_cloud
    batched = bench.bench_batched(cfg, sweeps, args.batch, bench.CHUNK, cap,
                                  device)
    distinct = bench.bench_batched_distinct(cfg, args.n_sweeps, args.batch,
                                            bench.CHUNK, cap, device)
    line = {"metric": "batched_ab", "preset": args.preset,
            "batched": round(batched, 4), "distinct": round(distinct, 4),
            "overrides": args.set}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
