"""Where the time of the sweep step goes on one CUDA card.

Replays the benchmark sequence through the VLP-16 preset at datasheet
capacities (as ``chip_smoke.py`` does) and measures, in one process:

- stage times of one odometry-only sweep and one mapping sweep (ingest,
  features, odometry, mapping; host clock between device syncs);
- one chunk of sweeps through ``Engine.run_chunk`` (on the card the
  CUDA graphs of ``models/graph.py``, captured in the warm-up chunk)
  without the profiler (host clock, ms/sweep), then the same chunk
  again from the same state under ``torch.profiler``: kernel launches
  from the host, graph launches, host-device syncs, the summed duration
  of the device's kernels and copies, their union on the device
  timeline (busy time), and the busy share of the profiled and of the
  unprofiled wall time; the profiled chunk's trace is written to
  ``build/profile_step/trace.json``;
- one call of the odometry Jacobian (``vmap(grad)``) at 512 points.

With ``--lanes B`` it profiles the batched replay instead
(``parallel/replay.py``: B identical lanes of the bench sequence, one
chunk of warm-up, then the next LANE_SWEEPS sweeps, one odometry-only
sweep and one mapping sweep, without and with the profiler): launches,
syncs, device operations, device busy share, ms per batched sweep and
the aggregate sweeps/s over all lanes; then the single stream on the
same sweeps after the same warm-up, so that the two counts of device
operations come from one process.

Prints one JSON object as its last line of output.

    python3 -m loam_velodyne_torch.tools.profile_step [--lanes 8]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.ops import scan as scan_mod
from loam_velodyne_torch.ops.features import extract_features
from loam_velodyne_torch.parallel import replay
from loam_velodyne_torch.utils import profiling

CHUNK = 8
# Sweeps of the profiled batched chunk (a whole chunk of 8 lanes did not
# finish under the profiler in 15 minutes on an H100).
LANE_SWEEPS = 2
SWEEP_CAP = 32768
# The profiled chunk's Chrome trace (viewable in Perfetto).
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "profile_step")
_LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _clone(tree):
    """Deep copy of a NamedTuple tree of tensors."""
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(x) for x in tree))
    return tree.clone()


def stage_times(state, raw, cfg: LoamConfig, mapping: bool) -> dict:
    """Milliseconds of each stage of one sweep, synced between stages."""
    dev = raw.xyz.device
    marks = [time.perf_counter()]

    def mark():
        engine_mod.sync(dev)
        marks.append(time.perf_counter())

    grid, _ = scan_mod.ingest_sweep(raw, cfg.lidar, cfg.registration)
    mark()
    feats = extract_features(grid, cfg.registration, cfg.capacities)
    mark()
    _, oouts = odometry_mod.step(state.odometry, feats, cfg, True)
    mark()
    names = ["ingest", "features", "odometry"]
    if mapping:
        mapping_mod.step(state.mapping, oouts.transform_sum,
                         oouts.corner_cloud, oouts.surf_cloud, cfg)
        mark()
        names.append("mapping")
    return {n: 1e3 * (b - a) for n, a, b in zip(names, marks, marks[1:])}


def device_activity(prof) -> dict:
    """Kernel and copy intervals on the device timeline: their count,
    summed duration and union (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    total = sum(b - a for a, b in spans)
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return {"device_events": len(spans), "device_sum_ms": total / 1e3,
            "device_busy_ms": busy / 1e3}


def profile_chunk(engine, xyz, mask, trace_dir: str) -> dict:
    """The chunk once without and once with the profiler, from one state;
    the profiled run's trace goes to ``trace_dir/trace.json``."""
    state0, cadence0 = _clone(engine.state), engine.cadence

    def restore():
        engine.state, engine.cadence = _clone(state0), cadence0

    return profile_calls(lambda: engine.run_chunk(xyz, mask), restore,
                         engine.device, xyz.shape[0], trace_dir)


def profile_calls(call, restore, dev: torch.device, n: int,
                  trace_dir: str) -> dict:
    """``call`` (n sweeps) once without and, after ``restore``, once with
    the profiler."""
    engine_mod.sync(dev)
    t0 = time.perf_counter()
    call()
    engine_mod.sync(dev)
    plain_s = time.perf_counter() - t0

    restore()
    with profiling.device_trace(trace_dir) as prof:
        t0 = time.perf_counter()
        call()
        engine_mod.sync(dev)
        prof_s = time.perf_counter() - t0
    rows = prof.key_averages()
    out = {
        "sweeps": n,
        "unprofiled_ms_per_sweep": 1e3 * plain_s / n,
        "profiled_ms_per_sweep": 1e3 * prof_s / n,
        "launches": sum(r.count for r in rows if r.key in _LAUNCH_APIS),
        "graph_launches": sum(r.count for r in rows
                              if r.key == "cudaGraphLaunch"),
        "syncs": {r.key: r.count for r in rows
                  if "Synchronize" in r.key or r.key.startswith("cudaMemcpy")},
        # Summing self device time over every row counts each kernel
        # twice: in its own row and in the operator that launched it.
        "self_device_ms_all_rows": sum(r.self_device_time_total
                                       for r in rows) / 1e3,
        "top_host_ops": [
            {"op": r.key, "count": r.count, "self_cpu_ms": r.self_cpu_time_total / 1e3}
            for r in sorted(rows, key=lambda r: -r.self_cpu_time_total)[:12]],
    }
    out.update(device_activity(prof))
    out["busy_share_of_profiled_wall"] = out["device_busy_ms"] / (1e3 * prof_s)
    out["busy_share_of_unprofiled_wall"] = out["device_busy_ms"] / (1e3 * plain_s)
    return out


def jacobian_ms(dev: torch.device, n: int = 512, reps: int = 20) -> float:
    gen = torch.Generator().manual_seed(0)
    tf = torch.zeros(6, device=dev)
    pts = torch.randn(n, 3, generator=gen).to(dev)
    coeff = torch.randn(n, 3, generator=gen).to(dev)
    odometry_mod._jacobian_rows(tf, pts, coeff)
    engine_mod.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        odometry_mod._jacobian_rows(tf, pts, coeff)
    engine_mod.sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def run(dev: torch.device, cfg: LoamConfig, cap: int, trace_dir: str) -> dict:
    """Warm up on one chunk, time the stages of the next two sweeps, then
    profile the chunk that follows the warm-up."""
    xyz, mask, _ = synthetic.bench_sequence(2 * CHUNK, cfg.lidar, cap)
    xyz = torch.from_numpy(xyz).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    engine = engine_mod.Engine(cfg, dev)
    engine.run_chunk(xyz[:CHUNK], mask[:CHUNK])
    stages = {}
    for i, kind in ((CHUNK, "odometry_only"), (CHUNK + 1, "mapping")):
        raw = scan_mod.RawSweep(xyz=xyz[i], mask=mask[i])
        for _ in range(2):                    # the first call warms up
            stages[kind] = stage_times(_clone(engine.state), raw, cfg,
                                       kind == "mapping")
    out = {"stages_ms": stages}
    out["chunk"] = profile_chunk(engine, xyz[CHUNK:], mask[CHUNK:], trace_dir)
    out["jacobian_512_ms"] = jacobian_ms(dev)
    return out


def run_lanes(dev: torch.device, cfg: LoamConfig, cap: int, trace_dir: str,
              lanes: int) -> dict:
    """The batched replay: B identical lanes of the bench sequence, one
    warm-up chunk, then the next LANE_SWEEPS sweeps without and with the
    profiler; then the single stream the same way."""
    xyz, mask, _ = synthetic.bench_sequence(2 * CHUNK, cfg.lidar, cap)
    xyz = torch.from_numpy(xyz).to(dev)[None].expand(lanes, -1, -1, -1)
    mask = torch.from_numpy(mask).to(dev)[None].expand(lanes, -1, -1)
    chunk = replay.make_batched_chunk(cfg)

    def raws(s):
        return scan_mod.RawSweep(xyz[:, s:s + CHUNK].contiguous(),
                                 mask[:, s:s + CHUNK].contiguous())

    states, _ = chunk(replay.create_states(cfg, lanes, dev), raws(0),
                      engine_mod.Cadence())
    cadence = engine_mod.Cadence()
    for _ in range(CHUNK):
        cadence = cadence.advance(cfg)
    second = scan_mod.RawSweep(xyz[:, CHUNK:CHUNK + LANE_SWEEPS].contiguous(),
                               mask[:, CHUNK:CHUNK + LANE_SWEEPS].contiguous())
    # The chunk leaves its input states as they were: nothing to restore.
    out = profile_calls(lambda: chunk(states, second, cadence),
                        lambda: None, dev, LANE_SWEEPS, trace_dir)
    out["lanes"] = lanes
    out["aggregate_sweeps_per_s"] = (lanes * 1e3
                                     / out["unprofiled_ms_per_sweep"])
    # The single stream on the same sweeps, in the same process.
    engine = engine_mod.Engine(cfg, dev)
    engine.run_chunk(xyz[0, :CHUNK], mask[0, :CHUNK])
    one = profile_chunk(engine, xyz[0, CHUNK:CHUNK + LANE_SWEEPS],
                        mask[0, CHUNK:CHUNK + LANE_SWEEPS],
                        os.path.join(trace_dir, "single"))
    # Device operations (kernels and copies) run, graphed or not.
    out["device_event_ratio_to_single_stream"] = (out["device_events"]
                                                  / one["device_events"])
    return {"batched_chunk": out, "single_stream_same_sweeps": one}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=0,
                    help="profile the batched replay with B lanes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    result = {"card": engine_mod.card(), "torch": torch.__version__}
    dev, cfg = torch.device("cuda:0"), LoamConfig.preset("VLP-16")
    if args.lanes:
        result.update(run_lanes(dev, cfg, SWEEP_CAP, TRACE_DIR, args.lanes))
    else:
        result.update(run(dev, cfg, SWEEP_CAP, TRACE_DIR))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
