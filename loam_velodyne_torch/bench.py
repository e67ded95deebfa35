"""The port's benchmark: VLP-16 full-pipeline throughput on one card.

Counterpart of the repository's ``bench.py`` (the JAX package's headline
measurement), function for function, with the same JSON lines:

    python -m loam_velodyne_torch.bench [n_sweeps=48] [batch=8] \\
        [--headline-only] [--set key=value ...] [--device cuda] [--out PATH]

Measured modes, on the noisy turning sequence (``synthetic.bench_sweeps``)
with the static shapes sized to the stream (``config.stream_cap`` and
``LoamConfig.sized_for_stream``, as ``bench.py`` sizes every cell):
- the headline: batched replay of ``batch`` distinct trajectories
  (``parallel/replay.py::make_batched_chunk``, ``chunk`` sweeps a call,
  the static cadence), in sweeps/s over all lanes;
- extras: the same with identical lanes; one stream through
  ``models/engine.py::run_chunk`` with the dynamic cadence (the JAX
  bench's single stream), its aligned ATE and its drop telemetry; the
  per-sweep latency of ``LoamDriver.run_live`` (p50, max, and the
  slowest sweep split into the driver's named segments and cadence
  events);
- without ``--headline-only``: the odometry-only ablation
  (``io_ratio = 10**6``) and the HDL-32 and HDL-64E presets, one line
  each.

Rates are read over the chunks after the first (the warm-up): the whole
stream is dispatched, then one ``torch.cuda.synchronize()`` stops the
clock. On the card the single stream and the live line replay the
per-sweep graphs (``models/engine.py::step_graphed``), the batched
replay the chunk's (``models/graph.py::ChunkGraphs``); the warm-ups
capture them, so no capture falls inside a timed window. Every line's ``vs_baseline`` is its rate over the reference's
real time, 10 sweeps/s (BASELINE.md). ``extra.device`` names the card
and its power limit as ``nvidia-smi`` prints them. The full run writes
``{"ts", "lines"}`` to ``--out`` (``build/bench_torch/latest.json``);
it never writes the JAX bench's ``BENCH_LATEST.json``.

Differences from ``bench.py``: the single stream's telemetry sums every
chunk (``bench.py`` sums the first and the last); rates are kept to 4
decimals and ATE to 5 (the port runs below 10 sweeps/s, where 2 keep
two digits); ``n_sweeps`` must be a multiple of 8 and at least 16, so
that a chunk follows the warm-up. There is no fallback: without a card,
or when a kernel fails to build or launch, the run raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from loam_velodyne_torch.config import LoamConfig, apply_overrides, stream_cap
from loam_velodyne_torch.eval.metrics import ate_rmse
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.models.engine import Engine, card, require_device, sync
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "bench_torch", "latest.json")
CAP = 32768
CHUNK = 8
REAL_TIME = 10.0            # sweeps/s of the reference in real time
# Sweeps that reach every per-sweep graph key of a run without an IMU:
# odometry's first sweep, then a mapping sweep.
LIVE_WARM_SWEEPS = 2


def require_timed_chunk(n_sweeps: int, chunk: int = CHUNK) -> None:
    """Rates are read over the chunks after the first (the warm-up):
    refuse a sweep count that is not a whole number of chunks or leaves
    no chunk after the warm-up."""
    if n_sweeps % chunk or n_sweeps < 2 * chunk:
        raise ValueError(f"n_sweeps must be a multiple of {chunk} and at least "
                         f"{2 * chunk} (a chunk after the warm-up), got "
                         f"{n_sweeps}")


def sum_telemetry(outs: list) -> dict:
    """The five drop counters summed over a list of chunk outputs (one
    read from the device)."""
    rows = []
    for o in outs:
        t, m = o.telemetry, o.telemetry.mapping
        rows.append(torch.stack([
            t.ingest_dropped.sum(), t.feature_dropped.sum(),
            (m.cube_corner_dropped + m.cube_surf_dropped).sum(),
            (m.stack_corner_dropped + m.stack_surf_dropped).sum(),
            m.active_cube_deficit.sum()]).to(torch.int64))
    total = torch.stack(rows).sum(0).tolist()
    return dict(zip(("ingest_dropped", "feature_dropped", "cube_dropped",
                     "stack_dropped", "active_cube_deficit"), total))


def bench_single_stream(cfg: LoamConfig, sweeps: list, gt: np.ndarray,
                        chunk: int, cap: int = CAP, device="cuda"):
    """One stream in chunks of ``chunk`` sweeps through ``Engine.run_chunk``
    with the dynamic cadence (the per-sweep cadence gate and GN
    schedules); returns (sweeps/s after the first chunk, aligned ATE in
    m, telemetry summed over all chunks)."""
    device = require_device(device)
    require_timed_chunk(len(sweeps), chunk)
    chunks = [tuple(torch.from_numpy(a).to(device)
                    for a in synthetic.pad_sweeps(sweeps[s:s + chunk], cap))
              for s in range(0, len(sweeps), chunk)]
    engine = Engine(cfg, device)
    outs = [engine.run_chunk(*chunks[0], static_cadence=False)]   # warm-up
    sync(device)
    t0 = time.perf_counter()
    for xyz, mask in chunks[1:]:
        outs.append(engine.run_chunk(xyz, mask, static_cadence=False))
    sync(device)
    rate = (len(sweeps) - chunk) / (time.perf_counter() - t0)
    est = torch.cat([o.fused_pose for o in outs]).cpu().numpy()[:, 3:]
    ate = ate_rmse(est, gt[:len(est)], align=True)
    return rate, ate, sum_telemetry(outs)


def _batched_rate(cfg: LoamConfig, lanes: list, chunk: int, cap: int,
                  device) -> float:
    """B lanes (each a list of sweeps, all of one length) through the
    batched chunk from one host cadence; sweeps/s over all lanes after
    the first chunk."""
    device = require_device(device)
    n = len(lanes[0])
    require_timed_chunk(n, chunk)
    raws = []
    for s in range(0, n, chunk):
        xyz, mask = zip(*(synthetic.pad_sweeps(lane[s:s + chunk], cap)
                          for lane in lanes))
        raws.append(RawSweep(torch.from_numpy(np.stack(xyz)).to(device),
                             torch.from_numpy(np.stack(mask)).to(device)))
    step = replay.make_batched_chunk(cfg)
    states = replay.create_states(cfg, len(lanes), device)
    cadence = replay.Cadence()
    for i, raw in enumerate(raws):
        if i == 1:                                 # after the warm-up
            sync(device)
            t0 = time.perf_counter()
        states, _ = step(states, raw, cadence)
        for _ in range(raw.xyz.shape[1]):
            cadence = cadence.advance(cfg)
    sync(device)
    return len(lanes) * (n - chunk) / (time.perf_counter() - t0)


def bench_batched(cfg: LoamConfig, sweeps: list, batch: int, chunk: int,
                  cap: int = CAP, device="cuda") -> float:
    """Batched static-cadence replay of ``batch`` identical lanes;
    returns sweeps/s over all lanes."""
    return _batched_rate(cfg, [sweeps] * batch, chunk, cap, device)


def distinct_lanes(n_sweeps: int, batch: int) -> list:
    """``batch`` distinct VLP-16 sequences, as ``bench.py`` builds them:
    lane b turns at 0.05 (1 + 0.4 b / batch) rad/s, to the left for odd
    b, sways at 0.15 + 0.02 b Hz, 5 mm of noise from each sweep's own
    seed."""
    lanes = []
    for b in range(batch):
        traj = synthetic.turning_trajectory(
            speed=1.0,
            yaw_rate=0.05 * (1.0 + 0.4 * b / batch) * (1 if b % 2 else -1),
            sway_freq=0.15 + 0.02 * b)
        sweeps, _, _ = synthetic.generate_sequence(
            n_sweeps, n_azimuth=900, speed=1.0, noise_std=0.005, traj=traj)
        lanes.append(sweeps)
    return lanes


def bench_batched_distinct(cfg: LoamConfig, n_sweeps: int, batch: int,
                           chunk: int, cap: int = CAP, device="cuda") -> float:
    """Batched replay of ``batch`` distinct trajectories
    (``distinct_lanes``): each lane's map fills differently, the fleet
    replay case; returns sweeps/s over all lanes."""
    return _batched_rate(cfg, distinct_lanes(n_sweeps, batch), chunk, cap,
                         device)


def bench_live_latency(cfg: LoamConfig, sweeps: list, n: int | None = None,
                       cap: int = CAP, device="cuda"):
    """Per-sweep latency of ``LoamDriver.run_live`` (pipelined one sweep
    deep) over sweeps 1..n after a warm-up sweep and a warm surround-map
    build, the graphs captured beforehand by a throwaway driver's first
    LIVE_WARM_SWEEPS sweeps: returns (p50 ms, max ms, attribution). The attribution splits
    the slowest sweep into the driver's segments (dispatch, stage,
    consume) and cadence events (surround map, archive compaction)."""
    n = len(sweeps) if n is None else n
    # A throwaway driver's first sweeps capture every per-sweep graph the
    # run replays (the engines of a configuration share them on the
    # card), so that no capture falls inside the timed sweeps.
    warm = LoamDriver(cfg, device, sweep_capacity=cap, system_delay=0)
    for pts in sweeps[:LIVE_WARM_SWEEPS]:
        warm.process_sweep(pts)
    drv = LoamDriver(cfg, device, sweep_capacity=cap, system_delay=0)
    drv.process_sweep(sweeps[0])
    # Warm the surround map too: run_live builds it on its cadence, and
    # its first build would otherwise charge one sweep.
    drv._build_surround()
    raw = [1e3 * t for t in drv.run_live(sweeps[1:n])]
    lat = sorted(raw)
    i_max = int(np.argmax(raw))
    ev = drv.live_events[i_max]
    attribution = {
        "max_sweep_index": i_max,
        "max_dispatch_ms": round(ev["dispatch_ms"], 1),
        "max_stage_ms": round(ev["stage_ms"], 1),
        "max_consume_ms": round(ev["consume_ms"], 1),
        "max_had_surround": bool(ev["surround"]),
        "max_had_compaction": bool(ev["compact"]),
        "surround_dispatches": drv.metrics.counters["surround_maps"],
        "archive_compactions": drv.metrics.counters["archive_compactions"],
    }
    return lat[len(lat) // 2], lat[-1], attribution


def rate_line(metric: str, rate: float, extra: dict) -> dict:
    return {"metric": metric, "value": round(rate, 4), "unit": "sweeps/s",
            "vs_baseline": round(rate / REAL_TIME, 5), "extra": extra}


def headline_line(cfg: LoamConfig, sweeps: list, gt: np.ndarray, batch: int,
                  chunk: int, cap: int, device="cuda") -> dict:
    """The headline line: distinct-lane batched throughput, with the
    identical-lane rate, the single stream, its ATE and telemetry, and
    the live latency in ``extra``."""
    device = require_device(device)
    stream_rate, ate, tel = bench_single_stream(cfg, sweeps, gt, chunk, cap,
                                                device)
    identical = bench_batched(cfg, sweeps, batch, chunk, cap, device)
    distinct = bench_batched_distinct(cfg, len(sweeps), batch, chunk, cap,
                                      device)
    p50, p_max, attribution = bench_live_latency(cfg, sweeps, cap=cap,
                                                 device=device)
    return rate_line("vlp16_full_pipeline_throughput", distinct, {
        "single_stream_sweeps_per_sec": round(stream_rate, 4),
        "single_stream_ms_per_sweep": round(1e3 / max(stream_rate, 1e-9), 2),
        "batched_sweeps_per_sec": round(identical, 4),
        "batched_distinct_sweeps_per_sec": round(distinct, 4),
        "batch": batch,
        "chunk": chunk,
        "ate_aligned_m": round(ate, 5),
        "live_step_ms_p50": round(p50, 1),
        "live_step_ms_max": round(p_max, 1),
        "live_max_attribution": attribution,
        "n_sweeps": len(sweeps) - chunk,
        "telemetry": tel,
        "device": card() if device.type == "cuda" else str(device),
    })


def odometry_only_line(cfg: LoamConfig, sweeps: list, gt: np.ndarray,
                       chunk: int, cap: int, device="cuda") -> dict:
    """The odometry-only ablation: the single stream with mapping fed
    once (``io_ratio = 10**6``)."""
    odo = dataclasses.replace(
        cfg, odometry=dataclasses.replace(cfg.odometry, io_ratio=10 ** 6))
    rate, ate, _ = bench_single_stream(odo, sweeps, gt, chunk, cap, device)
    return rate_line("vlp16_odometry_only", rate,
                      {"ate_aligned_m": round(ate, 5)})


def preset_line(name: str, cfg: LoamConfig, sweeps: list, gt: np.ndarray,
                chunk: int, cap: int, device="cuda") -> dict:
    """One lidar preset's single-stream line, ``<key>_full_pipeline``."""
    rate, ate, tel = bench_single_stream(cfg, sweeps, gt, chunk, cap, device)
    key = name.lower().replace("-", "")
    return rate_line(f"{key}_full_pipeline", rate,
                      {"ate_aligned_m": round(ate, 5), "telemetry": tel})


def key_paths(tree: dict, prefix: str = "") -> set:
    """Every key of a line, nested keys as dotted paths."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= key_paths(v, f"{prefix}{k}.")
    return out


def write_artifact(lines: list, path: str) -> None:
    """``{"ts", "lines"}`` of a full run, to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"ts": time.time(), "lines": lines}, f, indent=1)


def sized(cfg: LoamConfig, sweeps: list) -> tuple[LoamConfig, int]:
    """The config sized to the stream and the sweeps' padding."""
    cap = stream_cap(sweeps)
    return cfg.sized_for_stream(cap), cap


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m loam_velodyne_torch.bench",
        description="VLP-16 full-pipeline throughput of the PyTorch port on "
                    "one card (the JAX bench.py's lines)")
    p.add_argument("n_sweeps", nargs="?", type=int, default=48,
                   help="sweeps a sequence (a multiple of 8, at least 16)")
    p.add_argument("batch", nargs="?", type=int, default=8,
                   help="lanes of the batched replay")
    p.add_argument("--headline-only", action="store_true",
                   help="only the headline line (no artifact)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override of the VLP-16 lines")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--out", default=OUT, help="the full run's artifact")
    args = p.parse_args(argv)
    try:
        require_timed_chunk(args.n_sweeps)
    except ValueError as e:
        p.error(str(e))
    if args.batch < 1:
        p.error(f"batch must be at least 1, got {args.batch}")
    return args


def main(argv=None) -> list:
    """Run the bench, print each line as it is measured; returns the
    lines."""
    args = parse_args(argv)
    device = require_device(args.device)
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    cfg = apply_overrides(LoamConfig.preset("VLP-16"), args.set)
    sweeps, gt = synthetic.bench_sweeps(args.n_sweeps, cfg.lidar)
    cfg, cap = sized(cfg, sweeps)
    emit(headline_line(cfg, sweeps, gt, args.batch, CHUNK, cap, device))
    if args.headline_only:
        return lines
    emit(odometry_only_line(cfg, sweeps, gt, CHUNK, cap, device))
    for name in ("HDL-32", "HDL-64E"):
        lcfg = LoamConfig.preset(name)
        lsweeps, lgt = synthetic.bench_sweeps(args.n_sweeps, lcfg.lidar)
        lcfg, lcap = sized(lcfg, lsweeps)
        emit(preset_line(name, lcfg, lsweeps, lgt, CHUNK, lcap, device))
    write_artifact(lines, args.out)
    return lines


if __name__ == "__main__":
    main()
