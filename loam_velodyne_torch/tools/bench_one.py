"""One preset's single-stream line, without the rest of the bench:

    python -m loam_velodyne_torch.tools.bench_one [preset=HDL-64E] [n_sweeps=48] \\
        [--datasheet-cap] [--set key=value ...] [--device cuda]

Counterpart of ``tools/bench_one.py``: ``bench.bench_single_stream`` on
the noisy turning sequence of one lidar preset, sized to the stream
(``bench.sized``) unless ``--datasheet-cap`` keeps the preset's
capacities. Prints the bench's per-preset line (``<key>_full_pipeline``)
with ``ms_per_sweep`` in ``extra``.
"""

from __future__ import annotations

import argparse
import json

from loam_velodyne_torch import bench
from loam_velodyne_torch.config import LoamConfig, apply_overrides
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models.engine import require_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m loam_velodyne_torch.tools.bench_one")
    p.add_argument("preset", nargs="?", default="HDL-64E")
    p.add_argument("n_sweeps", nargs="?", type=int, default=48)
    p.add_argument("--datasheet-cap", action="store_true",
                   help="the preset's capacities, not sized to the stream")
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
    sweeps, gt = synthetic.bench_sweeps(args.n_sweeps, cfg.lidar)
    if args.datasheet_cap:
        cap = cfg.capacities.full_cloud
    else:
        cfg, cap = bench.sized(cfg, sweeps)
    line = bench.preset_line(args.preset, cfg, sweeps, gt, bench.CHUNK, cap,
                             device)
    line["extra"]["ms_per_sweep"] = round(1e3 / line["value"], 2)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
