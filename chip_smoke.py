"""Smoke run of the PyTorch port on one CUDA card.

Builds the four CUDA kernels of ``loam_velodyne_torch`` from the sources
in this checkout, compares each with its plain PyTorch version at every
VLP-16 main-path shape, and K1-K3 also at the HDL-64E preset's shapes
(the cases ending in ``_hdl64e``), and times it there (the wrapper, its
device work in a CUDA graph, the plain version, a library call where
one computes the same function, and the bound from
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
card, printed on its own line and as ``floor_ms``.

Then it drives the per-sweep path (``io/driver.py::LoamDriver``: the
"auto" cadence and the dynamic GN schedules) on ``cuda:0`` at the same
preset, with the launch counts set to 0 just before and read just
after: the first 8 sweeps through ``process_sweep`` without an IMU must
give the replay's poses; then 24 sweeps through ``run_live`` with an
IMU tracker fed a rocking-attitude stream (its own copy of the stream
of tests/test_oracle.py, gain 1) and an auto-checkpoint after sweep 16
must give finite rows, zero telemetry, mapping on odd sweeps, the
surround count the cadence implies and ATE within the JAX package's
IMU gate; its first 8 poses must differ from those without the IMU,
and its first 3 must agree with the port's CPU run of the same input
with the IMU (the plain versions of the kernels); a second driver
resumes from the checkpoint and must reproduce sweeps 16-23. It prints the launches per sweep of each
kernel on this path, the live latency (p50, max) and the slowest
sweep's ``live_events``.

Then the real-data entry points on ``cuda:0`` (``run_entry_points``),
through the loam-torch command run in this process (``cli.main``) and
the driver, with the launch counts set to 0 before and read after: the
native reader library builds and equals the Python readers bit for bit;
``validate`` records a golden on a 6-sweep VLP-16 wire-format pcap
(``loam_velodyne_torch/tools/make_validation_pcap.py``) and gates the
next replay against it within 1e-4, and the trajectory is within 5 cm
ATE of the simulator;
``run --source bag`` on a 5-sweep bag with an IMU must reach ATE
< 15 cm, and ``run_bag`` after a resume must skip the consumed clouds
and reproduce the rest within 1e-6; ``run --source kitti --lidar
HDL-64E`` on 8 simulated sweeps at datasheet capacities must give
finite poses, zero loss counters and ATE <= 5 cm, and every kernel call
of that run, recorded on the way to the wrapper, must equal its plain
version (each timed in a CUDA graph, under ``hdl64e`` in its kernel's
row); ``run --lidar HDL-32`` on 8 simulated sweeps must give the same
gates; a sensor thread feeding 24 sweeps at 10 Hz into a ``LiveFeeder``
over a card driver must account for every sweep; ``profile`` writes a
trace and ``info`` lists the card.

Then the trajectory gates (``run_trajectory_gates``): the driver on the
input of ``tests/golden_trajectory.npz`` within its 2e-3 over the sweeps
before the second mapping frame, and the replay's 48 sweeps against the
JAX package's CPU replay of the same sequence
(``tests/bench_trajectory_jax.npz``) by aligned cross-ATE and largest
pose deviation. Last, the batched replay (``run_batched``,
``parallel/replay.py``): 8 identical lanes of the bench sequence held to
the replay's first 24 sweeps (and to each other, bit for bit), then 8
distinct sequences (ATE and loss counters per lane, lanes 0 and 5 held
to single-stream runs of their own), the lane forms' launches counted
from 0 for each and exact, every lane-form call of the distinct run
recorded inside the ops' vmap rules and held bit-equal to its plain
twin after the counts are read; the aggregate sweeps/s over all lanes
is printed beside the single stream's. The lane forms have their own
rows in the kernel phase (``*_lanes``, at B = 8 main-path draws).

Then the compiled chunk (``run_graph``, ``models/graph.py``): the
static chunk as CUDA graphs of one group of io_ratio sweeps, through
the entry points a user calls, with the launch counts set to 0 before
each run and read after it. ``Engine.run_chunk`` replays the 48-sweep
bench sequence from a fresh state: every packed column bit-equal to
the eager replay above, ATE and zero telemetry;
``make_batched_chunk``'s callable runs the batched phase's 8 distinct
lanes, each bit-equal to the eager batched run. The graphs skip on the
card the GN phases and iterations after the stop (conditional nodes,
``models/conditional.py``; on every lane in the batched form), which
the eager runs compute masked: each graphed run's launches, counted on
the card (``ops/launches.py``), are the eager run's launches whose
regions' predicates all held there (``launches.needed``), K3's and
K4's fewer than the eager run's. The last chunk of each runs under
``torch.cuda.set_sync_debug_mode("error")``. It prints each graph's
warm-up, capture and instantiation seconds, nodes, conditional nodes
and pool memory, the batched run's peak memory, and the sweeps/s
graphed beside eager on the same sweeps. Every earlier and later phase
runs the eager chunk (the module function ``engine.run_chunk``,
``make_eager_batched_chunk``; the bench phase with
``make_batched_chunk`` returning the eager chunk), so that its
recorders see every kernel call, and holds each call to its plain twin
there; the multi-process workers run the graphs, held bit-equal to
this process's eager lanes.

Then the per-sweep graphs (``run_sweep_graphs``,
``models/engine.py::step_graphed``): the dynamic per-sweep step
replayed as CUDA graphs of its segments, each GN's phases and
iterations conditional nodes decided on the card (no stop flag read),
under ``LoamDriver.run_live`` on the per-sweep phase's 24 bench sweeps:
with that phase's IMU input against its eager live run, and without
the IMU against an eager run of the same sweeps, every packed column
bit-equal and the launches equal, no key captured inside a run (a
throwaway driver's first two sweeps capture them), conditional nodes in
both GN keys. It prints each run's sweeps/s and p50 / max beside the
eager run's, the graph replays and kernel launches a sweep, the host's
syncs a graphed sweep (a short run under the profiler: the driver's one
packed-row read a sweep, and no other synchronizing call a sweep), and
each graph's
set-up, nodes, conditional nodes and pool bytes. The per-sweep,
entry-point, trajectory-gate, oracle and bench phases step the eager
path (``device_split.eager_steps``): on the card
``Engine.step`` replays these graphs, which run without Python, and
those phases count or record the kernel calls.

Then three phases. The multi-process replay (``run_multiprocess``,
``parallel/multihost.py`` through ``tools/dryrun_dcn.py``): two fresh
processes share the card over gloo, two lanes each, and gather all four
lanes' trajectories; each worker's lane-form launches, counted on the
card, are exact (those this process's eager run of its lanes needed,
``launches.needed``), the gathered arrays equal, lane 0 of both ranks
bit-equal, and every lane
bit-equal to this process's own B = 2 run of the same lanes, with ATE
and loss-counter gates. The sized replay (``run_sized``): the bench
sequence at ``LoamConfig.sized_for_stream`` of its stream's padding
(``config.stream_cap``; P = 1,152), ATE, loss counters and launches
gated, every kernel call held bit-equal to its plain version, K3's and
K4's shapes those of the datasheet capacities; K1 and K2 also run at
its shapes in the kernel phase (the cases ending in ``_sized``). The
oracle gates (``run_oracle``): the card's driver against the NumPy
oracle's committed run (``tests/oracle_trajectory.npz``) with
tests/test_oracle.py's gates at 10 and 30 sweeps. Last, the bench
(``run_bench``): ``loam_velodyne_torch/bench.py`` with
``--headline-only`` at 16 sweeps and B = 2 in this process, its line
(printed as the bench prints it) held to the JAX bench's headline keys
(BENCH_LATEST.json), ATE <= 5 cm and zero telemetry, each kernel's
calls counted by lane count (single-lane and at B = 2) and every call
launched. It imports only ``loam_velodyne_torch`` (never JAX or the JAX
package).

Run from the repository root:  python3 chip_smoke.py
Every failure raises (non-zero exit). The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it is the card's
``name, power.limit``, and before that one JSON object with each
kernel's launches, error, times and bound, the heaviest main-path case
at the top level and every case under ``cases``, its launches on the
per-sweep path under ``per_sweep_path``, on the per-sweep graphs
under ``per_sweep_graphs``, on the entry points under
``entry_points`` and on the HDL-64E run under ``hdl64e``, the launch
floor, and the phases' numbers under ``per_sweep``, ``entry_points``,
``trajectory_gates``, ``batched``, ``graph``, ``sweep_graphs``,
``multiprocess``, ``sized``, ``oracle`` and ``bench``; every row has its launches and calls in the
bench phase under ``bench``; a lane form's row has its launches over
the batched phase, its engine calls under ``batched_calls`` and each
worker's launches
under ``multiprocess``; a single-lane row its launches and engine calls
in the sized run under ``sized`` and its launches in the oracle run
under ``oracle``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from loam_velodyne_torch import bench as port_bench
from loam_velodyne_torch import cli
from loam_velodyne_torch.config import HDL64E, LoamConfig, stream_cap
from loam_velodyne_torch.eval.metrics import ate_rmse, rpe_rmse
from loam_velodyne_torch.io import driver as driver_mod
from loam_velodyne_torch.io import kitti, native, pcap, rosbag, synthetic
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.io.live import LiveFeeder
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.models.engine import Engine, sync
from loam_velodyne_torch.models.engine import card as engine_card
from loam_velodyne_torch.ops import (corresp_kernel, cuda_lib, features,
                                     greedy_kernel, grid_kernel, knn_kernel,
                                     neighbors, scan, voxel)
from loam_velodyne_torch.ops import launches as launch_counts
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay as replay_mod
from loam_velodyne_torch.tools import (device_split, dryrun_dcn, kernel_times,
                                       make_validation_pcap)

SEED = 0
N_SWEEPS = 48
CHUNK = 8
SWEEP_CAP = 32768
ATE_GATE_M = 0.05
# The per-sweep phase: sweeps compared with the replay, sweeps of the
# live IMU run, the auto-checkpoint, and the gates (the IMU gate is the
# JAX package's, tests/test_oracle.py).
DYN_SWEEPS = 8
LIVE_SWEEPS = 24
CKPT_EVERY = 16
DYN_TOL_M = 1e-5
RESUME_TOL = 1e-6
IMU_ATE_GATE_M = 0.15
# The IMU run must move the first DYN_SWEEPS poses off the run without
# it by more than the CPU tests' IMU tolerance, and its first
# IMU_CPU_SWEEPS must agree with the port's CPU run of the same input
# within that tolerance (tests/test_torch_driver.py).
IMU_TOL = 1e-3
# Three: on the second sweep the card and the CPU pick different flat
# points among near-equal curvatures (the curvature's prefix sums round
# in another order on the card), and the fourth, the second mapping
# frame, amplifies the state that carries into a 3.7e-3 pose deviation
# on an H100; from a common state it parts by 2.5e-5
# (tools/device_split.py, which steps this input).
IMU_CPU_SWEEPS = 3
# The entry-points phase: the wire-format pcap (sweeps, the golden gate,
# the ATE gate), the rosbag with an IMU (sweeps, ATE gate, the resume
# bag's sweeps and checkpoint), the HDL-64E KITTI run and the live feeder.
WIRE_SWEEPS = 6
GOLDEN_TOL_M = 1e-4
BAG_SWEEPS = 5
BAG_ATE_GATE_M = 0.15
RESUME_SWEEPS, RESUME_AT = 6, 3
HDL_SWEEPS = 8
FEED_SWEEPS = 24
# The batched phase: B lanes, sweeps per lane (chunks of CHUNK; the
# rates are read over the chunks after the first), (a) B identical lanes
# of the bench sequence held to the replay's first sweeps, (b) B
# distinct sequences (lane i: its own noise seed and speed), lanes
# SINGLE_LANES held to single-stream runs of their own.
LANES = 8
LANE_SWEEPS = 24
LANE_SPEEDS = (1.0, 0.5, 0.75, 1.25, 1.5, 0.6, 0.9, 1.1)
LANE_SEEDS = tuple(100 + i for i in range(LANES))
SINGLE_LANES = (0, 5)
# A lane against the single stream on the same input, by the largest
# pose deviation (PERF.md's batched-replay findings; the split located
# by tools/lane_split.py on an H100):
# - at B = 1 the batched chunk is the single stream bit for bit (24
#   sweeps), so the first chunk at B = 1 must equal the replay's rows;
# - at B = 8, given equal inputs, only the Gauss-Newton normal matrix
#   (``solve_gn``'s batched product) rounds otherwise, by a few ulps:
#   sweep 3 from a common state parts by 3.0e-7, and sweeps 0-2 from
#   the start by at most 2.1e-7. LANE_PREFIX_TOL gates those sweeps: a
#   lane that read another lane's data, or took another lane's result,
#   parts by orders of magnitude more there;
# - from the second mapping frame (sweep 3) the map turns that carried
#   rounding into discrete changes (3.6e-3 on sweep 3, 2.4e-2 by sweep
#   23), as it turns the card's rounding against the CPU's; no gate over
#   all sweeps can be tighter than that amplification, so LANE_TOL is
#   the measured 2.4e-2 with a margin.
LANE_PREFIX_SWEEPS = 3
LANE_PREFIX_TOL = 1e-6
LANE_TOL = 0.03
# The graph phase's batched depth (the batched phase's, LANE_SWEEPS).
GRAPH_LANE_SWEEPS = LANE_SWEEPS
# Sweeps of the per-sweep graph phase's profiled run (its host syncs):
# enough that a synchronizing call made once in the run (set-up) tells
# apart from one made each sweep.
SYNC_SWEEPS = 8
# The driver's read of a graphed sweep's packed row: the one
# synchronizing call a sweep that run_live makes.
ROW_READ_SYNC = "cudaEventSynchronize"
# The golden (tests/test_golden.py: the JAX driver, 6 VLP-16 sweeps; its
# 2e-3 gates the sweeps before the second mapping frame, from which the
# JAX package itself no longer meets it on the CPU, see
# tests/test_torch_trajectory_gates.py; the later sweeps are printed
# beside the JAX driver's own deviation there) and the JAX package's static-
# cadence replay of the bench sequence (that file writes it). Gates on
# the latter, set from a measured run (PERF.md's batched-replay
# findings): aligned cross-ATE of the fused positions and the largest
# deviation of the 18 pose columns.
GOLDEN_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden_trajectory.npz")
GOLDEN_SWEEPS, GOLDEN_GATE_SWEEPS, GOLDEN_TRAJ_TOL = 6, 3, 2e-3
BENCH_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "bench_trajectory_jax.npz")
BENCH_CROSS_ATE_M = 5e-3
BENCH_MAX_DEV = 0.02
# The multi-process phase: the dry run's VLP-16 preset
# (loam_velodyne_torch/tools/dryrun_dcn.py: two fresh processes sharing
# the card, two lanes each, 16 sweeps in chunks of CHUNK, one gloo
# all_gather at the end), its report in the git-ignored build directory,
# the workers killed after MULTI_TIMEOUT_S.
MULTI_PRESET = "VLP-16"
MULTI_REPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke", "dryrun_dcn.json")
MULTI_TIMEOUT_S = 600
# The sized phase: the bench sequence's first SIZED_SWEEPS sweeps at
# ``LoamConfig.sized_for_stream`` of their padding (``config.stream_cap``),
# and the kernel cases run at its shapes.
SIZED_SWEEPS = 16
SIZED_CASES = ("grid", "greedy_corner", "greedy_flat")
# The oracle phase: tests/test_oracle.py's VLP-16 gates (10 and 30 noisy
# turning sweeps) against the NumPy oracle's committed run
# (``python tests/test_torch_trajectory_gates.py oracle`` writes it).
ORACLE_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "oracle_trajectory.npz")
ORACLE_SWEEPS = (10, 30)
ORACLE_CROSS_M, ORACLE_GT_M, ORACLE_RATIO = 0.05, 0.15, 1.2
# The bench phase: the port's bench (loam_velodyne_torch/bench.py) with
# --headline-only at BENCH_SWEEPS sweeps and BENCH_LANES lanes, its line's
# keys held to the JAX bench's headline line in BENCH_LATEST.json.
BENCH_SWEEPS = 16
BENCH_LANES = 2
BENCH_LATEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BENCH_LATEST.json")


def _nvcc_version() -> str:
    out = subprocess.run([cuda_lib.nvcc(), "--version"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def replay(engine: Engine, xyz: torch.Tensor, mask: torch.Tensor,
           graphed: bool = False, no_sync_from: int | None = None):
    """Run the sequence through the engine in chunks of CHUNK sweeps:
    eagerly (the module function ``engine.run_chunk`` on the engine's
    state and cadence, every kernel call made from Python, so the
    recorders see it), or ``graphed`` (``Engine.run_chunk``: the CUDA
    graphs). Chunks from index ``no_sync_from`` on run under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the (n, 29)
    packed outputs and the host times at which each chunk had finished
    on the device."""
    packed, ends = [], []
    for i, s in enumerate(range(0, xyz.shape[0], CHUNK)):
        x, m = xyz[s:s + CHUNK], mask[s:s + CHUNK]
        if no_sync_from is not None and i >= no_sync_from:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if graphed:
                outs = engine.run_chunk(x, m)
            else:
                engine.state, outs = engine_mod.run_chunk(
                    engine.state, RawSweep(x, m), engine.cfg, engine.cadence)
                for _ in range(x.shape[0]):
                    engine.cadence = engine.cadence.advance(engine.cfg)
        finally:
            if no_sync_from is not None:
                torch.cuda.set_sync_debug_mode(0)
        packed.append(outs.packed)
        sync(engine.device)
        ends.append(time.perf_counter())
    return torch.cat(packed), ends


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
        "loam_velodyne_tpu/ops/pallas_grid.py:56",
        ("grid", "grid_hdl64e", "grid_sized"), "grid"),
    "greedy_pick_rows": (
        greedy_kernel.greedy_pick_rows, greedy_kernel.greedy_pick_rows_plain,
        "loam_velodyne_torch/csrc/greedy.cu",
        "loam_velodyne_tpu/ops/pallas_greedy.py:90",
        ("greedy_corner", "greedy_flat", "greedy_corner_hdl64e",
         "greedy_flat_hdl64e", "greedy_corner_sized", "greedy_flat_sized"),
        "greedy_corner"),
    "corresp_search": (
        corresp_kernel.corresp_search, corresp_kernel.corresp_search_plain,
        "loam_velodyne_torch/csrc/corresp.cu",
        "loam_velodyne_tpu/ops/pallas_corresp.py:137",
        ("corresp_corner", "corresp_surf", "corresp_corner_hdl64e",
         "corresp_surf_hdl64e"), "corresp_surf"),
    "grouped_window_knn": (
        knn_kernel.grouped_window_knn, knn_kernel.grouped_window_knn_plain,
        "loam_velodyne_torch/csrc/knn.cu",
        "loam_velodyne_tpu/ops/pallas_knn.py:59",
        ("knn_corner", "knn_surf"), "knn_surf"),
    # The lane forms (the batched replay), at B = LANES main-path draws.
    "grid_windows_lanes": (
        grid_kernel.grid_windows_lanes, grid_kernel.grid_windows_lanes_plain,
        "loam_velodyne_torch/csrc/grid.cu",
        "loam_velodyne_tpu/ops/pallas_grid.py:56", ("grid_lanes",),
        "grid_lanes"),
    "greedy_pick_rows_lanes": (
        greedy_kernel.greedy_pick_rows_lanes,
        greedy_kernel.greedy_pick_rows_lanes_plain,
        "loam_velodyne_torch/csrc/greedy.cu",
        "loam_velodyne_tpu/ops/pallas_greedy.py:90",
        ("greedy_corner_lanes", "greedy_flat_lanes"), "greedy_corner_lanes"),
    "corresp_search_lanes": (
        corresp_kernel.corresp_search_lanes,
        corresp_kernel.corresp_search_lanes_plain,
        "loam_velodyne_torch/csrc/corresp.cu",
        "loam_velodyne_tpu/ops/pallas_corresp.py:137",
        ("corresp_corner_lanes", "corresp_surf_lanes"), "corresp_surf_lanes"),
    "grouped_window_knn_lanes": (
        knn_kernel.grouped_window_knn_lanes,
        knn_kernel.grouped_window_knn_lanes_plain,
        "loam_velodyne_torch/csrc/knn.cu",
        "loam_velodyne_tpu/ops/pallas_knn.py:59",
        ("knn_corner_lanes", "knn_surf_lanes"), "knn_surf_lanes"),
}
# Launches of each kernel in the 48-sweep replay: K1 once and K2 twice
# per sweep, K3 10 times per odometry sweep (47), K4 10 times per
# mapping frame (24).
# Calls timed for a lane form's plain twin's ``plain_ms`` (the K2 twin
# takes ~0.4 s a call; the single-lane plain versions take
# ``kernel_times.time_ms``'s default 50).
LANE_PLAIN_REPS = 10
EXPECTED_LAUNCHES = {"grid_windows": 48, "greedy_pick_rows": 96,
                     "corresp_search": 470, "grouped_window_knn": 240}


def _library_call(case: str, args: tuple):
    """One PyTorch call that computes the same function, its output laid
    out as the wrapper's (timed as a yardstick, never called by the
    port), or None where there is none."""
    if case.endswith("_lanes") and case.startswith("grid"):
        cols, starts, p = args
        lane = torch.arange(cols.shape[0], device=cols.device)[:, None]
        idx = starts.long()
        return lambda: cols.unfold(2, p, 1)[lane, :, idx]     # (B, R, C, P)
    if case.startswith("grid"):
        cols, starts, p = args
        return lambda: torch.index_select(cols.unfold(1, p, 1), 1,
                                          starts).permute(1, 0, 2)
    return None


def _outputs(name: str, out) -> tuple:
    """A wrapper's outputs as a tuple (K1 and the segment sums return
    one tensor)."""
    return out if isinstance(out, tuple) else (out,)


def check_kernels(dev, sized: tuple) -> list[dict]:
    """Each kernel against its plain version on the card at every
    main-path shape (inputs from a numpy seed), then timed: the wrapper
    and the plain version by CUDA events around back-to-back calls
    (``ms``, ``plain_ms``: what a caller pays, host time included); the
    wrapper and the library call captured in a CUDA graph, which replays
    only their device work (``kernel_ms``, ``library_ms``: the device's
    time with the host out of the way); the host's time to enqueue a
    wrapper call (``host_ms``); the wrapper's device operations per call
    and their summed durations (``device_ms``, from the profiler); beside
    the bound computed from the same inputs. ``sized``: the sized config
    and its sweep padding (``sized_config``), at whose shapes K1 and K2
    also run (the cases ending in ``_sized``)."""
    inputs = kernel_times.main_path_inputs(dev, SEED)
    inputs.update({f"{k}_hdl64e": v for k, v in kernel_times.main_path_inputs(
        dev, SEED, LoamConfig.preset("HDL-64E")).items()})
    inputs.update({f"{k}_sized": v for k, v in kernel_times.main_path_inputs(
        dev, SEED, *sized).items() if k in SIZED_CASES})
    inputs.update(kernel_times.lane_inputs(dev, SEED, lanes=LANES))
    rows = []
    for name, (wrapper, plain, source, replaces, cases, head) in KERNELS.items():
        per_case, err = {}, 0.0
        for case in cases:
            args = inputs[case]
            got = wrapper(*args)
            want = plain(*args)
            got, want = _outputs(name, got), _outputs(name, want)
            err = max(err, _require_equal(f"{name} {case}", got, want))
            k_fn, l_fn = (lambda: wrapper(*args)), _library_call(case, args)
            if l_fn is not None:
                _require_equal(f"{name} {case} library call",
                               (l_fn().contiguous(),), got)
            ms = kernel_times.time_ms(k_fn)
            kernel_ms = kernel_times.graph_ms(k_fn)
            plain_ms = kernel_times.time_ms(
                lambda: plain(*args),
                *((LANE_PLAIN_REPS,) if name.endswith("_lanes") else ()))
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


WRAPPERS = {"grid_windows": grid_kernel.grid_windows,
            "greedy_pick_rows": greedy_kernel.greedy_pick_rows,
            "corresp_search": corresp_kernel.corresp_search,
            "grouped_window_knn": knn_kernel.grouped_window_knn}


def _zero_launches() -> None:
    launch_counts.settle()
    for fn in WRAPPERS.values():
        fn.launches = 0


def _read_launches() -> dict:
    """The wrappers' launch counts, the graphs' settled from the card's
    counters first (one read)."""
    launch_counts.settle()
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _needed(tally) -> dict:
    """A ``launch_counts.needed`` block's tally, by every wrapper: the
    launches a graphed run of the block's work makes."""
    got = tally()
    return {name: got.get(name, 0) for name in WRAPPERS}


# Call sites of the four wrappers in the pipeline: (module, name).
CALL_SITES = {"grid_windows": (scan, "grid_windows"),
              "greedy_pick_rows": (features, "greedy_pick_rows"),
              "corresp_search": (neighbors, "corresp_search"),
              "grouped_window_knn": (neighbors, "grouped_window_knn")}


@contextlib.contextmanager
def _recording_calls(*names):
    """Record a copy of the arguments (args, kwargs) of every call the
    pipeline makes to the named kernels (all four by default), by
    kernel, on the way to the wrapper."""
    calls = {name: [] for name in names or CALL_SITES}

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recorder(name, wrapper):
        def call(*args, **kwargs):
            calls[name].append((tuple(copy(a) for a in args),
                                {k: copy(v) for k, v in kwargs.items()}))
            return wrapper(*args, **kwargs)
        return call

    for name in calls:
        mod, attr = CALL_SITES[name]
        setattr(mod, attr, recorder(name, WRAPPERS[name]))
    try:
        yield calls
    finally:
        for name in calls:
            mod, attr = CALL_SITES[name]
            setattr(mod, attr, WRAPPERS[name])


def run_engine(dev, card: str
               ) -> tuple[dict, list, np.ndarray, list, float, dict]:
    """Replay the benchmark sequence through the port's engine. Returns
    the kernels' launch counts, K2's calls (their arguments), which the
    replay records on the way to the wrapper, the packed rows, each
    chunk's ms per sweep, the sweeps/s after the first chunk, and the
    launches the CUDA graphs of the same replay make
    (``launch_counts.needed``)."""
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, gt = synthetic.bench_sequence(N_SWEEPS, cfg.lidar, SWEEP_CAP)
    xyz_d = torch.from_numpy(xyz).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    engine = Engine(cfg, dev)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    with _recording_calls("greedy_pick_rows") as calls, \
            launch_counts.needed() as needed:
        packed, ends = replay(engine, xyz_d, mask_d)
    greedy_calls = [args for args, _ in calls["greedy_pick_rows"]]
    t_first, t_end = ends[0], ends[-1]
    chunk_ms = [1e3 * (b - a) / CHUNK for a, b in zip([t0] + ends, ends)]
    launches = _read_launches()
    needed = _needed(needed)
    print(f"engine kernel launches: {json.dumps(launches)}; of them in GN "
          f"regions whose predicates held (the graphs run these): "
          f"{json.dumps(needed)}", flush=True)
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
          f"after the first chunk, card: {card}; ms/sweep by chunk "
          f"{[round(v, 2) for v in chunk_ms]}", flush=True)
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"ATE {ate:.4f} m above the {ATE_GATE_M} m gate")
    return launches, greedy_calls, packed, chunk_ms, steady_rate, needed


# The lane forms' custom ops (each module's ``lane_op``), by lane form;
# the lane segment sums ride with them.
LANE_OPS = {"grid_windows_lanes": grid_kernel.lane_op,
            "greedy_pick_rows_lanes": greedy_kernel.lane_op,
            "corresp_search_lanes": corresp_kernel.lane_op,
            "grouped_window_knn_lanes": knn_kernel.lane_op,
            "segment_sum_lanes": voxel.lane_op}
LANE_TWINS = {**{k: v[1] for k, v in KERNELS.items() if k.endswith("_lanes")},
              "segment_sum_lanes": voxel.segment_sum_lanes_plain}


@contextlib.contextmanager
def _recording_lane_calls():
    """Record a copy of the arguments of every lane-form call that the
    vmapped pipeline makes, by lane form, inside the ops' vmap rules
    (where the tensors are the real (B, ...) ones)."""
    calls = {name: [] for name in LANE_OPS}
    saved = {name: op.lanes for name, op in LANE_OPS.items()}

    def recorder(name, fn):
        def call(*args):
            calls[name].append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                     else a for a in args))
            return fn(*args)
        return call

    for name, op in LANE_OPS.items():
        op.lanes = recorder(name, saved[name])
    try:
        yield calls
    finally:
        for name, op in LANE_OPS.items():
            op.lanes = saved[name]


def _distinct_sequence(cfg: LoamConfig, seed: int, speed: float):
    """A bench-like sequence of LANE_SWEEPS sweeps: the turning
    trajectory at ``speed``, 5 mm of point noise drawn from ``seed``,
    padded to SWEEP_CAP rows: (xyz, mask, gt)."""
    sweeps, gt = synthetic.noisy_turning(LANE_SWEEPS, cfg.lidar, seed, speed)
    return (*synthetic.pad_sweeps(sweeps, SWEEP_CAP), gt)


def _batched_replay(cfg: LoamConfig, xyz: torch.Tensor, mask: torch.Tensor,
                    no_sync_from: int | None = None, chunk=None):
    """B lanes of (B, n, N, 3) / (B, n, N) sweeps through the batched
    chunk, CHUNK sweeps a call from one host cadence: eagerly
    (``make_eager_batched_chunk``, every lane-form call made from
    Python, so the recorders see it) or through ``chunk`` (a callable
    of ``make_batched_chunk``: the CUDA graphs). Chunks from index
    ``no_sync_from`` on run under ``torch.cuda.set_sync_debug_mode(
    "error")``. Returns the packed rows (B, n, 29) and each chunk's
    seconds."""
    if chunk is None:
        chunk = replay_mod.make_eager_batched_chunk(cfg)
    states = replay_mod.create_states(cfg, xyz.shape[0], xyz.device)
    cadence = replay_mod.Cadence()
    packed, secs = [], []
    for i, s in enumerate(range(0, xyz.shape[1], CHUNK)):
        sync(xyz.device)
        t0 = time.perf_counter()
        raws = RawSweep(xyz[:, s:s + CHUNK].contiguous(),
                        mask[:, s:s + CHUNK].contiguous())
        if no_sync_from is not None and i >= no_sync_from:
            torch.cuda.set_sync_debug_mode("error")
        try:
            states, outs = chunk(states, raws, cadence)
        finally:
            if no_sync_from is not None:
                torch.cuda.set_sync_debug_mode(0)
        for _ in range(CHUNK):
            cadence = cadence.advance(cfg)
        packed.append(outs.packed)
        sync(xyz.device)
        secs.append(time.perf_counter() - t0)
    return torch.cat(packed, 1).cpu().numpy(), secs


def _lane_launches(expected: dict) -> dict:
    """The kernels' launches since the counts were set to 0: one per
    call for all lanes (a kernel has one launch path, its lane form)."""
    got = _read_launches()
    if got != expected:
        raise AssertionError(f"lane launches {got}, expected {expected}")
    return got


def _shapes(args: tuple) -> str:
    return "; ".join("x".join(map(str, x.shape)) for x in args
                     if isinstance(x, torch.Tensor))


def batched_calls(calls: dict) -> dict:
    """Each recorded lane-form call against its plain twin (bit-equal)
    and, for the four kernels, its time in a CUDA graph, grouped by the
    shapes of its tensor arguments."""
    out = {}
    for name, args_list in calls.items():
        fn, twin = LANE_OPS[name].lanes, LANE_TWINS[name]
        groups = {}
        for i, a in enumerate(args_list):
            got, want = _outputs(name, fn(*a)), _outputs(name, twin(*a))
            _require_equal(f"{name} batched call {i}", got, want)
            groups.setdefault(_shapes(a), []).append(
                None if name == "segment_sum_lanes" else
                kernel_times.graph_ms(lambda a=a: fn(*a), 10, 5))
        out[name] = [{"shapes": k, "calls": len(v),
                      "kernel_ms_mean": None if v[0] is None else sum(v) / len(v),
                      "kernel_ms_max": None if v[0] is None else max(v)}
                     for k, v in groups.items()]
        for o in out[name]:
            timed = ("" if o["kernel_ms_mean"] is None else
                     f"; in a graph {o['kernel_ms_mean']:.4f} ms a call "
                     f"(max {o['kernel_ms_max']:.4f})")
            print(f"batched {name} [{o['shapes']}]: {o['calls']} calls, each "
                  f"bit-equal to the plain twin{timed}", flush=True)
    return out


def _lane_devs(got: np.ndarray, want: np.ndarray) -> tuple[list, float, float]:
    """A lane's rows against a single stream's: the largest pose
    deviation by sweep, over the prefix and over all sweeps."""
    by_sweep = np.abs(got[:, :18] - want[:, :18]).max(axis=1)
    return (by_sweep.tolist(), float(by_sweep[:LANE_PREFIX_SWEEPS].max()),
            float(by_sweep.max()))


def _fmt(xs) -> list:
    return [float(f"{x:.3g}") for x in xs]


def run_batched(dev, card: str, replay_packed: np.ndarray,
                replay_chunk_ms: list) -> tuple[dict, tuple]:
    """The batched replay (``parallel/replay.py``) at VLP-16 on the card:
    one lane of one chunk against the replay's rows (bit-equal), then
    LANES lanes of LANE_SWEEPS sweeps in chunks of CHUNK: (a) identical
    lanes of the bench sequence against the replay's rows; (b) distinct
    sequences, each lane's ATE and loss counters, lanes SINGLE_LANES
    against single-stream runs of their own sequences. The rate over
    all lanes is read on the chunks after the first, beside the
    replay's (``replay_chunk_ms``) on the same sweeps. The launch counts
    are set to 0 before each run and read after it; every lane-form call
    of (b) is recorded and, after the counts are read, held to its
    plain twin. All readings are printed before any gate is applied.
    Every run is the eager batched chunk. Returns the phase's numbers
    and the distinct run's (xyz, mask, packed rows, chunk seconds, the
    launches a graphed run of it makes, ``launch_counts.needed``)."""
    t_phase = time.perf_counter()
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, _ = synthetic.bench_sequence(LANE_SWEEPS, cfg.lidar, SWEEP_CAP)
    xyz_d = torch.from_numpy(xyz).to(dev)[None].expand(LANES, -1, -1, -1)
    mask_d = torch.from_numpy(mask).to(dev)[None].expand(LANES, -1, -1)
    n_odo = LANE_SWEEPS - 1
    expected = {"grid_windows": LANE_SWEEPS,
                "greedy_pick_rows": 2 * LANE_SWEEPS,
                "corresp_search": 10 * n_odo,
                "grouped_window_knn": 10 * (LANE_SWEEPS // 2)}
    out = {"lanes": LANES, "sweeps_per_lane": LANE_SWEEPS}
    failures = []

    # One lane, one chunk: the single stream bit for bit.
    packed, _ = _batched_replay(cfg, xyz_d[:1, :CHUNK], mask_d[:1, :CHUNK])
    out["one_lane_equal"] = bool(np.array_equal(packed[0],
                                                replay_packed[:CHUNK]))
    print(f"batched: one lane, sweeps 0-{CHUNK - 1}: equal to the replay's "
          f"rows bit for bit: {out['one_lane_equal']}", flush=True)
    if not out["one_lane_equal"]:
        failures.append("one lane differs from the single stream")

    # (a) identical lanes.
    sync(dev)
    _zero_launches()
    packed, secs = _batched_replay(cfg, xyz_d, mask_d)
    out["identical_launches"] = _lane_launches(expected)
    ref = replay_packed[:LANE_SWEEPS]
    by_sweep, prefix_dev, max_dev = _lane_devs(packed[0], ref)
    same = all(np.array_equal(packed[0], packed[i]) for i in range(LANES))
    # Flags and loss counters exact; the archive's reinstated rows and
    # cursor (columns 27-28) follow the map, which the deviation moves.
    flags_equal = bool((packed[:, :, 18:27] == ref[None, :, 18:27]).all())
    archive_dev = np.abs(packed[0, :, 27:29] - ref[:, 27:29]).max(0).tolist()
    # Rates after the first chunk, by chunk, and the single stream's on
    # the same sweeps of its replay earlier in this call.
    rates = [LANES * CHUNK / x for x in secs[1:]]
    single = [1e3 / ms for ms in replay_chunk_ms[1:len(secs)]]
    rate = LANES * (LANE_SWEEPS - CHUNK) / sum(secs[1:])
    single_rate = (LANE_SWEEPS - CHUNK) / (
        sum(replay_chunk_ms[1:len(secs)]) * CHUNK / 1e3)
    print(f"batched (a): {LANES} identical lanes x {LANE_SWEEPS} sweeps; "
          f"largest pose deviation of lane 0 from the single-stream replay by "
          f"sweep {_fmt(by_sweep)} (gates {LANE_PREFIX_TOL} on sweeps "
          f"0-{LANE_PREFIX_SWEEPS - 1}, {LANE_TOL} on all); lanes equal to "
          f"each other: {same}; flags and loss counters equal to the replay's: "
          f"{flags_equal}; archive rows reinstated and cursor off by "
          f"{archive_dev}", flush=True)
    print(f"batched (a): sweeps {CHUNK}-{LANE_SWEEPS - 1}: {rate:.3f} sweeps/s "
          f"over all {LANES} lanes (by chunk {[round(r, 3) for r in rates]}; "
          f"{[round(1e3 * x / CHUNK, 2) for x in secs]} ms a batched sweep by "
          f"chunk, the first included) against {single_rate:.3f} sweeps/s of "
          f"the single stream on the same sweeps in this call (by chunk "
          f"{[round(r, 3) for r in single]}): {rate / single_rate:.2f}x; "
          f"card: {card}", flush=True)
    print(f"batched (a) lane launches per chunk of {CHUNK} sweeps: "
          + json.dumps({k: v * CHUNK / LANE_SWEEPS
                        for k, v in out["identical_launches"].items()}),
          flush=True)
    if not (prefix_dev <= LANE_PREFIX_TOL and max_dev <= LANE_TOL and same
            and flags_equal):
        failures.append(f"identical lanes: deviation {by_sweep}, equal "
                        f"{same}, flags {flags_equal}")
    out.update(identical_max_dev=max_dev, identical_prefix_max_dev=prefix_dev,
               identical_lanes_equal=same, identical_max_dev_by_sweep=by_sweep,
               identical_archive_dev=archive_dev, chunk_s=secs,
               sweeps_per_sec=rate, sweeps_per_sec_by_chunk=rates,
               single_stream_sweeps_per_sec=single_rate,
               single_stream_sweeps_per_sec_by_chunk=single)

    # (b) distinct lanes.
    seqs = [_distinct_sequence(cfg, seed, speed)
            for seed, speed in zip(LANE_SEEDS, LANE_SPEEDS)]
    xyz_b = torch.from_numpy(np.stack([q[0] for q in seqs])).to(dev)
    mask_b = torch.from_numpy(np.stack([q[1] for q in seqs])).to(dev)
    sync(dev)
    _zero_launches()
    with _recording_lane_calls() as calls, \
            launch_counts.needed() as needed:
        packed, secs = _batched_replay(cfg, xyz_b, mask_b)
    out["distinct_launches"] = _lane_launches(expected)
    distinct_needed = _needed(needed)
    if not np.isfinite(packed).all():
        raise AssertionError("distinct lanes: outputs not finite")
    ates = [ate_rmse(packed[i, :, 15:18], seqs[i][2], align=True)
            for i in range(LANES)]
    # Every loss counter (all but archive_reinstated, column 27).
    losses = packed[:, :, 20:27].sum(axis=1)
    rate_b = LANES * (LANE_SWEEPS - CHUNK) / sum(secs[1:])
    print(f"batched (b): {LANES} distinct lanes (speeds {list(LANE_SPEEDS)} "
          f"m/s), ATE by lane {[round(100 * a, 3) for a in ates]} cm, loss "
          f"counters {losses.sum(0).tolist()}; {rate_b:.3f} sweeps/s after "
          f"the first chunk (by chunk "
          f"{[round(LANES * CHUNK / x, 3) for x in secs[1:]]})", flush=True)
    if max(ates) > ATE_GATE_M or losses.any():
        failures.append(f"distinct lanes: ATE {ates}, losses {losses}")
    singles = {}
    for i in SINGLE_LANES:
        one, _ = replay(Engine(cfg, dev), xyz_b[i], mask_b[i])
        one = one.cpu().numpy()
        singles[i] = _lane_devs(packed[i], one)
        print(f"batched (b): lane {i} against a single-stream run of its "
              f"sequence: largest pose deviation by sweep "
              f"{_fmt(singles[i][0])}; flags and loss counters equal: "
              f"{np.array_equal(packed[i, :, 18:27], one[:, 18:27])}",
              flush=True)
        if not (singles[i][1] <= LANE_PREFIX_TOL and singles[i][2] <= LANE_TOL
                and np.array_equal(packed[i, :, 18:27], one[:, 18:27])):
            failures.append(f"lane {i} against its single stream: "
                            f"{singles[i][0]}")
    out.update(distinct_ate_m=ates,
               distinct_single_max_dev={i: v[2] for i, v in singles.items()},
               distinct_single_prefix_max_dev={i: v[1]
                                               for i, v in singles.items()},
               distinct_sweeps_per_sec=rate_b)
    out["calls"] = batched_calls(calls)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"batched: the phase took {out['seconds']:.1f} s", flush=True)
    if failures:
        raise AssertionError("batched phase: " + "; ".join(failures))
    return out, (xyz_b, mask_b, packed, secs, distinct_needed)


def _graph_stats(graphs, label: str, card: str) -> list:
    """Each captured graph's warm-up, capture and instantiation seconds,
    nodes, conditional nodes and the shared pool's bytes, printed."""
    rows = []
    for (_, shape, imu, branch), st in graphs.stats.items():
        first = not branch[0][0]
        rows.append({"group_shape": list(shape), "imu": imu,
                     "first_group": first, **st._asdict()})
        print(f"graph {label}, {'first' if first else 'steady'} group of "
              f"{list(shape)}: warm-up {st.warmup_s:.2f} s, capture "
              f"{st.capture_s:.2f} s, instantiation {st.instantiate_s:.2f} s, "
              f"{st.nodes} nodes ({st.conditional_nodes} conditional nodes), "
              f"the shared pools {st.pool_bytes / 2**20:.1f} MiB after it; "
              f"card: {card}", flush=True)
    return rows


def run_graph(dev, card: str, replay_packed: np.ndarray, replay_chunk_ms: list,
              replay_needed: dict, distinct: tuple, identical_rate: float
              ) -> tuple[dict, dict]:
    """The compiled chunk (``models/graph.py``): the static chunk replayed
    as CUDA graphs of one group of io_ratio sweeps, through the entry
    points a user calls, each run with the launch counts set to 0 before
    and read after. (1) ``Engine.run_chunk`` over the 48-sweep bench
    sequence from a fresh state: every packed column bit-equal to the
    eager replay of ``run_engine`` (``replay_packed``), the launches
    ATE and zero telemetry; (2) ``make_batched_chunk``'s callable over
    the batched phase's LANES distinct lanes (``distinct``: their sweeps,
    the eager run's rows, chunk seconds and needed launches), its first
    GRAPH_LANE_SWEEPS sweeps bit-equal to the eager lanes; its rate
    beside the eager distinct run's (recorded, so slowed by the
    recorder's clones) and the eager identical lanes' (``identical_rate``,
    unrecorded). The eager runs run every GN phase (EXPECTED_LAUNCHES);
    the graphs skip, on the card, the phases and iterations after a GN's
    stop (on every lane): each run's launches, counted on the card, are
    those the eager run needed (``replay_needed``, the distinct run's:
    its launches whose regions' predicates all held), K3's and K4's
    fewer than the eager run's. The last chunk of each runs under
    ``torch.cuda.set_sync_debug_mode("error")``. Prints each graph's
    capture and instantiation seconds, nodes and pool memory, the
    batched run's peak memory, and the sweeps/s graphed against eager on
    the same sweeps in this process (after the first chunk). Returns the
    launches by run and the phase's numbers."""
    t_phase = time.perf_counter()
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, gt = synthetic.bench_sequence(N_SWEEPS, cfg.lidar, SWEEP_CAP)
    xyz_d = torch.from_numpy(xyz).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    failures = []

    # (1) The single stream.
    engine = Engine(cfg, dev)
    sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    packed, ends = replay(engine, xyz_d, mask_d, graphed=True,
                          no_sync_from=N_SWEEPS // CHUNK - 1)
    single_launches = _read_launches()
    packed = packed.cpu().numpy()
    chunk_ms = [1e3 * (b - a) / CHUNK for a, b in zip([t0] + ends, ends)]
    differ = [int(c) for c in np.nonzero(
        (packed != replay_packed).any(axis=0))[0]]
    ate = ate_rmse(packed[:, 15:18], gt, align=True)
    ate_eager = ate_rmse(replay_packed[:, 15:18], gt, align=True)
    telemetry = packed[:, 20:28].sum(0).tolist()
    rate = (N_SWEEPS - CHUNK) / (sum(chunk_ms[1:]) * CHUNK / 1e3)
    rate_eager = (N_SWEEPS - CHUNK) / (sum(replay_chunk_ms[1:]) * CHUNK / 1e3)
    print(f"graph single stream: {N_SWEEPS} sweeps through Engine.run_chunk "
          f"(CUDA graphs), the last chunk under sync debug mode 'error'; "
          f"columns differing from the eager replay: {differ} (of 29); "
          f"launches {json.dumps(single_launches)} (counted on the card; "
          f"expected {json.dumps(replay_needed)}; eager "
          f"{json.dumps(EXPECTED_LAUNCHES)}); "
          f"ATE {ate * 100:.3f} cm (eager {ate_eager * 100:.3f} cm), telemetry "
          f"{telemetry}", flush=True)
    print(f"graph single stream: sweeps {CHUNK}-{N_SWEEPS - 1}: {rate:.3f} "
          f"sweeps/s graphed ({1e3 / rate:.2f} ms a sweep; by chunk "
          f"{[round(v, 2) for v in chunk_ms]} ms a sweep, the first with its "
          f"captures) against {rate_eager:.3f} sweeps/s eager on the same "
          f"sweeps in this process: {rate / rate_eager:.2f}x; card: {card}",
          flush=True)
    single_stats = _graph_stats(engine.graphs, "single stream", card)
    if (differ or single_launches != replay_needed
            or not all(single_launches[k] < EXPECTED_LAUNCHES[k]
                       for k in ("corresp_search", "grouped_window_knn"))):
        failures.append(f"single stream: columns {differ} differ, launches "
                        f"{single_launches}, expected {replay_needed}")
    if not ate <= ATE_GATE_M or any(telemetry):
        failures.append(f"single stream: ATE {ate}, telemetry {telemetry}")

    # (2) The batched chunk, LANES distinct lanes.
    xyz_b, mask_b, eager_packed, eager_secs, eager_needed = distinct
    n = GRAPH_LANE_SWEEPS
    if n != LANE_SWEEPS:
        raise AssertionError("the distinct run's needed launches cover "
                             f"{LANE_SWEEPS} sweeps, not {n}")
    chunk = replay_mod.make_batched_chunk(cfg)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    packed_b, secs = _batched_replay(cfg, xyz_b[:, :n], mask_b[:, :n],
                                     no_sync_from=n // CHUNK - 1, chunk=chunk)
    batched_launches = _read_launches()
    eager_b = _expected_launches(n)
    peak = torch.cuda.max_memory_allocated(dev)
    lanes_equal = [bool(np.array_equal(packed_b[i], eager_packed[i, :n]))
                   for i in range(LANES)]
    rate_b = LANES * (n - CHUNK) / sum(secs[1:])
    rate_b_eager = LANES * (n - CHUNK) / sum(eager_secs[1:n // CHUNK])
    print(f"graph batched: {LANES} distinct lanes x {n} sweeps through "
          f"make_batched_chunk (CUDA graphs), the last chunk under sync debug "
          f"mode 'error'; each lane bit-equal to the eager batched run: "
          f"{lanes_equal}; launches {json.dumps(batched_launches)} (counted "
          f"on the card; expected {json.dumps(eager_needed)}; eager "
          f"{json.dumps(eager_b)}); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"graph batched: sweeps {CHUNK}-{n - 1}: {rate_b:.3f} sweeps/s over "
          f"all {LANES} lanes graphed (by chunk "
          f"{[round(LANES * CHUNK / x, 3) for x in secs[1:]]}; "
          f"{[round(1e3 * x / CHUNK, 2) for x in secs]} ms a batched sweep, "
          f"the first with its captures) against {rate_b_eager:.3f} eager on "
          f"the same sweeps in this process (its calls recorded): "
          f"{rate_b / rate_b_eager:.2f}x; against the eager identical lanes "
          f"(unrecorded) {identical_rate:.3f}: "
          f"{rate_b / identical_rate:.2f}x; card: {card}", flush=True)
    batched_stats = _graph_stats(chunk.graphs, f"batched B = {LANES}", card)
    if (not all(lanes_equal) or batched_launches != eager_needed
            or not all(batched_launches[k] < eager_b[k]
                       for k in ("corresp_search", "grouped_window_knn"))):
        failures.append(f"batched: lanes equal {lanes_equal}, launches "
                        f"{batched_launches}, expected {eager_needed}")
    out = {"single": {"columns_differing": differ, "ate_m": ate,
                      "ate_eager_m": ate_eager, "telemetry": telemetry,
                      "launches": single_launches,
                      "eager_launches": EXPECTED_LAUNCHES,
                      "ms_per_sweep_by_chunk": chunk_ms,
                      "sweeps_per_sec": rate, "eager_sweeps_per_sec": rate_eager,
                      "graphs": single_stats},
           "batched": {"lanes": LANES, "sweeps": n, "lanes_equal": lanes_equal,
                       "launches": batched_launches, "eager_launches": eager_b,
                       "chunk_s": secs,
                       "sweeps_per_sec": rate_b,
                       "eager_sweeps_per_sec": rate_b_eager,
                       "eager_identical_sweeps_per_sec": identical_rate,
                       "peak_memory_bytes": peak, "graphs": batched_stats},
           "no_sync_chunks": "the last chunk of each run",
           "seconds": time.perf_counter() - t_phase}
    print(f"graph: the phase took {out['seconds']:.1f} s; card: {card}",
          flush=True)
    if failures:
        raise AssertionError("graph phase: " + "; ".join(failures))
    return {"single": single_launches, "batched": batched_launches}, out


def _sweep_graph_stats(graphs, card: str) -> list:
    """Each per-sweep graph's key, warm-up, capture and instantiation
    seconds, nodes, conditional nodes and the shared pool's bytes after
    it, printed."""
    rows = []
    for key, st in graphs.stats.items():
        rows.append({"key": [str(k) for k in key], **st._asdict()})
        print(f"sweep graph {key[0]} {list(key[1:])}: warm-up "
              f"{st.warmup_s:.2f} s, capture {st.capture_s:.2f} s, "
              f"instantiation {st.instantiate_s:.2f} s, {st.nodes} nodes "
              f"({st.conditional_nodes} conditional nodes), the shared pools "
              f"{st.pool_bytes / 2**20:.1f} MiB after it; card: {card}",
              flush=True)
    return rows


def _host_syncs(call, dev) -> dict:
    """The host's synchronizing CUDA calls during ``call()``, by name
    (``torch.profiler``, the card traced; the profiler's own syncs at its
    start and end are not in its rows)."""
    sync(dev)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
    return {r.key: r.count for r in prof.key_averages()
            if "Synchronize" in r.key}


def run_sweep_graphs(dev, card: str, cfg: LoamConfig, xyz: np.ndarray,
                     mask: np.ndarray, live_ref: tuple) -> tuple[dict, dict]:
    """The per-sweep graphs (``models/engine.py::step_graphed`` through
    ``graph.SweepGraphs``) under ``LoamDriver.run_live``, the entry point
    a user calls, on the per-sweep phase's LIVE_SWEEPS bench sweeps at
    full VLP-16 width. (1) A throwaway driver steps sweeps 0 and 1 with
    and without the IMU: it captures every key the runs below replay
    (the set-up, timed apart). (2) With the per-sweep phase's IMU input,
    graphed, against that phase's eager live run (``live_ref``: its
    packed rows, launches and latencies). (3) Without the IMU, eagerly
    (``device_split.eager_steps``, the plain reference), then graphed.
    Each graphed run: every packed column bit-equal to the eager one,
    the same launches (counted from 0 over the run, the graphs' on the
    card), no key captured. The GN's stop is decided on the card
    (conditional nodes): no stop flag is read. (4) The host's
    synchronizing calls in a graphed ``run_live`` without the IMU
    (SYNC_SWEEPS sweeps under ``torch.profiler``, after the timed runs):
    at most one ROW_READ_SYNC a sweep (the driver's packed row) and no
    other synchronizing call made each sweep (at most one in the run).
    Prints each run's sweeps/s, p50 / max beside the eager run's, the
    graph replays and kernel launches a sweep, the syncs, and each
    graph's set-up, nodes, conditional nodes and pool bytes. Returns the
    graphed runs' launches by run and the phase's numbers."""
    t_phase = time.perf_counter()
    sweeps = [xyz[i][mask[i]] for i in range(LIVE_SWEEPS)]
    stamps = [0.1 * k for k in range(LIVE_SWEEPS)]
    cap = xyz.shape[1]
    graphs = graph_mod.sweep_graphs(cfg, dev)
    failures = []

    # (1) The set-up.
    sync(dev)
    t0 = time.perf_counter()
    for drv, st in ((LoamDriver(cfg, dev, sweep_capacity=cap, system_delay=0),
                     [None, None]), (_imu_driver(cfg, dev, cap), stamps)):
        for pts, stamp in zip(sweeps[:2], st):
            drv.process_sweep(pts, stamp)
    sync(dev)
    setup_s = time.perf_counter() - t0
    keys = set(graphs.stats)
    stats = _sweep_graph_stats(graphs, card)
    nodes = sum(st["nodes"] or 0 for st in stats)
    pool = graph_mod.pool_bytes(dev)
    print(f"sweep graphs: {len(keys)} keys captured in {setup_s:.1f} s (two "
          f"sweeps with and two without the IMU, their steps included), "
          f"{nodes} nodes in all, the shared pool {pool / 2**20:.1f} MiB; "
          f"card: {card}", flush=True)

    # (3)'s eager reference, without the IMU.
    with device_split.eager_steps():
        drv = LoamDriver(cfg, dev, sweep_capacity=cap, system_delay=0)
        rows = _keep_rows(drv)
        sync(dev)
        _zero_launches()
        lat = drv.run_live(sweeps)
        sync(dev)
        eager = (np.concatenate(rows), _read_launches(), [1e3 * x for x in lat])

    runs, launches = {}, {}
    for name, drv, st, ref in (
            ("imu", _imu_driver(cfg, dev, cap), stamps, live_ref),
            ("no_imu", LoamDriver(cfg, dev, sweep_capacity=cap, system_delay=0),
             None, eager)):
        rows = _keep_rows(drv)
        sync(dev)
        _zero_launches()
        replays0 = graphs.replays
        lat = [1e3 * x for x in drv.run_live(sweeps, st)]
        sync(dev)
        launches[name] = _read_launches()
        rows = np.concatenate(rows)
        differ = [int(c) for c in np.nonzero((rows != ref[0]).any(axis=0))[0]]
        n = len(sweeps)
        ms, ms_eager = sorted(lat), sorted(ref[2])
        run = {"columns_differing": differ, "launches": launches[name],
               "eager_launches": ref[1],
               "sweeps_per_sec": 1e3 * n / sum(lat),
               "eager_sweeps_per_sec": 1e3 * n / sum(ref[2]),
               "p50_ms": ms[n // 2], "max_ms": ms[-1],
               "eager_p50_ms": ms_eager[n // 2], "eager_max_ms": ms_eager[-1],
               "replays_per_sweep": (graphs.replays - replays0) / n,
               "launches_per_sweep": {k: v / n for k, v
                                      in launches[name].items()},
               "live_ms": lat}
        runs[name] = run
        print(f"sweep graphs, run_live {'with' if name == 'imu' else 'without'} "
              f"the IMU, {n} sweeps: columns differing from the eager run "
              f"{differ} (of 29); launches {json.dumps(launches[name])} (eager "
              f"{json.dumps(ref[1])}); {run['sweeps_per_sec']:.3f} sweeps/s "
              f"graphed against {run['eager_sweeps_per_sec']:.3f} eager "
              f"({run['sweeps_per_sec'] / run['eager_sweeps_per_sec']:.2f}x); "
              f"p50 {run['p50_ms']:.1f} ms, max {run['max_ms']:.1f} ms (eager "
              f"{run['eager_p50_ms']:.1f} / {run['eager_max_ms']:.1f} ms); "
              f"{run['replays_per_sweep']:.2f} graph replays and launches "
              f"{json.dumps(run['launches_per_sweep'])} a sweep; card: {card}",
              flush=True)
        if differ or launches[name] != ref[1] or not all(ref[1].values()):
            failures.append(f"{name}: columns {differ} differ, launches "
                            f"{launches[name]} against {ref[1]}")
    if set(graphs.stats) != keys:
        failures.append(f"captured inside the runs: {set(graphs.stats) - keys}")
    # (4) The host's syncs a graphed sweep.
    drv = LoamDriver(cfg, dev, sweep_capacity=cap, system_delay=0)
    syncs = _host_syncs(lambda: drv.run_live(sweeps[:SYNC_SWEEPS]), dev)
    per_sweep_syncs = {k: v for k, v in syncs.items()
                       if v > (SYNC_SWEEPS if k == ROW_READ_SYNC else 1)}
    print(f"sweep graphs: host syncs in a graphed run_live of {SYNC_SWEEPS} "
          f"sweeps (no IMU, under the profiler): {json.dumps(syncs)}; "
          f"synchronizing calls besides the packed rows' {ROW_READ_SYNC}s "
          f"(a stop-flag read would add one each GN phase): "
          f"{sum(syncs.values()) - syncs.get(ROW_READ_SYNC, 0)}", flush=True)
    if per_sweep_syncs:
        failures.append(f"synchronizing calls made each graphed sweep beyond "
                        f"one {ROW_READ_SYNC}: {per_sweep_syncs}")
    conditional_nodes = {" ".join(map(str, k)): st.conditional_nodes
                         for k, st in graphs.stats.items()}
    gn_keys = [("odometry", True), ("mapping",)]
    if not all(graphs.stats[k].conditional_nodes for k in gn_keys):
        failures.append(f"GN keys without conditional nodes: "
                        f"{conditional_nodes}")
    out = {"setup_s": setup_s, "keys": len(keys), "nodes": nodes,
           "conditional_nodes": conditional_nodes, "pool_bytes": pool,
           "graphs": stats, "runs": runs,
           "host_syncs_per_sweep": {k: v / SYNC_SWEEPS
                                    for k, v in syncs.items()},
           "seconds": time.perf_counter() - t_phase}
    print(f"sweep graphs: the phase took {out['seconds']:.1f} s; card: {card}",
          flush=True)
    if failures:
        raise AssertionError("sweep graph phase: " + "; ".join(failures))
    return launches, out


def run_trajectory_gates(dev, replay_packed: np.ndarray) -> dict:
    """The card against the committed references: the port's driver on
    the golden's input (tests/golden_trajectory.npz, the JAX driver's
    6-sweep run) within GOLDEN_TRAJ_TOL, and the replay's 48 sweeps
    against the JAX package's replay of the bench sequence
    (tests/bench_trajectory_jax.npz) by the aligned cross-ATE of the
    fused positions and the largest pose deviation."""
    cfg = LoamConfig.preset("VLP-16")
    sweeps, _, _ = synthetic.generate_sequence(GOLDEN_SWEEPS, n_azimuth=900,
                                               speed=1.0)
    drv = LoamDriver(cfg, dev, system_delay=0)
    for pts in sweeps:
        drv.process_sweep(pts)
    with np.load(GOLDEN_NPZ) as g:
        golden = g["trajectory"]
    traj = np.stack(drv.trajectory)
    golden_by_sweep = np.abs(traj - golden).max(axis=1)
    golden_dev = float(golden_by_sweep[:GOLDEN_GATE_SWEEPS].max())
    with np.load(BENCH_NPZ) as b:
        ref, jax_driver = b["poses"], b["golden_driver"]
    jax_by_sweep = np.abs(jax_driver - golden).max(axis=1)
    cross_ate = ate_rmse(replay_packed[:, 15:18], ref[:, 15:18], align=True)
    by_sweep = np.abs(replay_packed[:, :18] - ref).max(axis=1)
    print(f"gates: the driver on the golden's {GOLDEN_SWEEPS} sweeps, largest "
          f"deviation by sweep {_fmt(golden_by_sweep)} (gate "
          f"{GOLDEN_TRAJ_TOL} on sweeps 0-{GOLDEN_GATE_SWEEPS - 1}; the JAX "
          f"driver's own on the CPU {_fmt(jax_by_sweep)}); the replay "
          f"against the JAX package's: cross-ATE {cross_ate * 100:.4f} cm "
          f"(gate {BENCH_CROSS_ATE_M * 100} cm), largest pose deviation "
          f"{by_sweep.max():.3g} on sweep {int(by_sweep.argmax())} (gate "
          f"{BENCH_MAX_DEV}); by chunk "
          f"{[float(f'{by_sweep[s:s + CHUNK].max():.3g}') for s in range(0, len(by_sweep), CHUNK)]}",
          flush=True)
    out = {"golden_max_dev_gated": golden_dev,
           "golden_max_dev_by_sweep": golden_by_sweep.tolist(),
           "golden_jax_cpu_max_dev_by_sweep": jax_by_sweep.tolist(),
           "bench_cross_ate_m": cross_ate,
           "bench_max_dev": float(by_sweep.max()),
           "bench_max_dev_by_sweep": by_sweep.tolist()}
    if not (traj.shape == golden.shape and np.isfinite(traj).all()
            and golden_dev <= GOLDEN_TRAJ_TOL
            and cross_ate <= BENCH_CROSS_ATE_M and by_sweep.max() <= BENCH_MAX_DEV):
        raise AssertionError(f"trajectory gates: {out}")
    return out


def _keep_rows(drv: LoamDriver) -> list:
    """A list that collects, in order, every packed row the driver
    consumes from now on."""
    rows, consume = [], drv._consume_packed

    def kept(p):
        rows.append(np.atleast_2d(np.asarray(p)).copy())
        consume(p)

    drv._consume_packed = kept
    return rows


def _imu_driver(cfg, dev, cap: int, **kw) -> LoamDriver:
    """The live run's driver, as tools/device_split.py builds it."""
    return device_split.imu_driver(cfg, dev, LIVE_SWEEPS, sweep_capacity=cap,
                                   **kw)


def run_per_sweep(dev, card: str, cfg: LoamConfig, xyz: np.ndarray,
                  mask: np.ndarray, gt: np.ndarray,
                  replay_packed: np.ndarray) -> tuple[dict, tuple, dict]:
    """The per-sweep path on the sequence (xyz, mask, gt) of at least
    LIVE_SWEEPS sweeps: LoamDriver against the replay's packed rows, the
    live loop with the IMU and an auto-checkpoint, and a resume from it.
    Returns the kernels' launch counts on this path, the live run's
    packed rows, launches and latencies (ms), and the phase's numbers."""
    sweeps = [xyz[i][mask[i]] for i in range(LIVE_SWEEPS)]
    gt = gt[:LIVE_SWEEPS]
    stamps = [0.1 * k for k in range(LIVE_SWEEPS)]
    sync(dev)
    _zero_launches()

    # Dynamic schedules and the "auto" cadence against the replay's
    # static ones, without an IMU.
    drv = LoamDriver(cfg, dev, sweep_capacity=xyz.shape[1], system_delay=0)
    for pts in sweeps[:DYN_SWEEPS]:
        drv.process_sweep(pts)
    got = np.concatenate([np.stack(drv.odom_trajectory),
                          np.stack(drv.mapped_trajectory),
                          np.stack(drv.trajectory)], axis=1)
    dyn_dev = float(np.abs(got - replay_packed[:DYN_SWEEPS, :18]).max())
    print(f"per-sweep: {DYN_SWEEPS} sweeps through process_sweep (dynamic GN, "
          f"auto cadence) against the replay's static chunk: largest pose "
          f"deviation {dyn_dev:.3g}", flush=True)
    if not dyn_dev <= DYN_TOL_M:
        raise AssertionError(f"dynamic against static: {dyn_dev} > {DYN_TOL_M}")

    # The live loop with the IMU and an auto-checkpoint.
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, "state.npz")
    live = _imu_driver(cfg, dev, xyz.shape[1], checkpoint_path=ckpt,
                       checkpoint_every=CKPT_EVERY)
    live_rows = _keep_rows(live)
    before = _read_launches()
    lat = live.run_live(sweeps, stamps)
    sync(dev)
    live_launches = {k: v - before[k] for k, v in _read_launches().items()}
    poses = np.concatenate([np.stack(live.odom_trajectory),
                            np.stack(live.mapped_trajectory),
                            np.stack(live.trajectory)], axis=1)
    if poses.shape != (LIVE_SWEEPS, 18) or not np.isfinite(poses).all():
        raise AssertionError("live outputs not finite or of the wrong shape")
    # Every loss counter stays 0; archive_reinstated counts archived map
    # rows moved back into the search slabs, not a loss.
    drops = {k: live.metrics.counters.get(k, 0)
             for k in LoamDriver._PACKED_COUNTERS if k != "archive_reinstated"}
    if any(drops.values()):
        raise AssertionError(f"live telemetry: points dropped: {drops}")
    reinstated = live.metrics.counters.get("archive_reinstated", 0)
    odd = [k % 2 == 1 for k in range(LIVE_SWEEPS)]
    if live.mapping_ran != odd:
        raise AssertionError(f"mapping ran on sweeps {live.mapping_ran}, "
                             f"expected the odd ones")
    mapping_frames = sum(odd)
    want_surround = -(-mapping_frames // cfg.mapping.map_frame_num)
    if live.surround_count != want_surround:
        raise AssertionError(f"surround count {live.surround_count}, expected "
                             f"{want_surround}")
    ate = ate_rmse(np.stack(live.trajectory)[:, 3:], gt, align=True)
    if not ate <= IMU_ATE_GATE_M:
        raise AssertionError(f"IMU ATE {ate:.4f} m above {IMU_ATE_GATE_M} m")
    # The IMU reached the poses on the card (the deskew, odometry's IMU
    # terms, the mapping blend): the run without it is far off.
    imu_moved = float(np.abs(poses[:DYN_SWEEPS] - got).max())
    print(f"per-sweep live with IMU: first {DYN_SWEEPS} poses against the run "
          f"without the IMU: largest difference {imu_moved:.3g}", flush=True)
    if not imu_moved > IMU_TOL:
        raise AssertionError(f"the IMU moved the poses by {imu_moved} <= {IMU_TOL}")
    ms = sorted(1e3 * x for x in lat)
    slowest = int(np.argmax(lat))
    print(f"per-sweep live with IMU: {LIVE_SWEEPS} sweeps, ATE {ate * 100:.3f} cm, "
          f"latency p50 {ms[len(ms) // 2]:.1f} ms, max {ms[-1]:.1f} ms (sweep "
          f"{slowest}: {json.dumps(live.live_events[slowest])}), surround maps "
          f"{live.surround_count}, archive rows reinstated {reinstated}, zero "
          f"drops, card: {card}", flush=True)

    # Resume from the auto-checkpoint and reproduce the rest.
    resumed = _imu_driver(cfg, dev, xyz.shape[1], checkpoint_path=ckpt)
    if not resumed.resume() or resumed.resumed_sweeps != CKPT_EVERY:
        raise AssertionError("resume from the auto-checkpoint failed")
    for pts, stamp in zip(sweeps[CKPT_EVERY:], stamps[CKPT_EVERY:]):
        resumed.process_sweep(pts, stamp)
    res_dev = float(np.abs(np.stack(resumed.trajectory)
                           - np.stack(live.trajectory[CKPT_EVERY:])).max())
    print(f"per-sweep resume: sweeps {CKPT_EVERY}-{LIVE_SWEEPS - 1} from the "
          f"checkpoint, largest pose deviation {res_dev:.3g}", flush=True)
    if not res_dev <= RESUME_TOL:
        raise AssertionError(f"resume: {res_dev} > {RESUME_TOL}")
    sync(dev)
    launches = _read_launches()
    n = DYN_SWEEPS + LIVE_SWEEPS + (LIVE_SWEEPS - CKPT_EVERY)
    print(f"per-sweep kernel launches over {n} sweeps: {json.dumps(launches)}; "
          f"per sweep: " + json.dumps({k: v / n for k, v in launches.items()}),
          flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the per-sweep path: {missing}")
    os.remove(ckpt)

    # The first sweeps of the IMU run on the CPU (the kernels' plain
    # versions), after the launch counts were read.
    t0 = time.perf_counter()
    cpu = _imu_driver(cfg, "cpu", xyz.shape[1])
    for pts, stamp in zip(sweeps[:IMU_CPU_SWEEPS], stamps):
        cpu.process_sweep(pts, stamp)
    cpu_poses = np.concatenate([np.stack(cpu.odom_trajectory),
                                np.stack(cpu.mapped_trajectory),
                                np.stack(cpu.trajectory)], axis=1)
    cpu_dev = np.abs(cpu_poses - poses[:IMU_CPU_SWEEPS]).max(axis=1)
    print(f"per-sweep live with IMU against the port on the CPU: sweeps "
          f"0-{IMU_CPU_SWEEPS - 1}, largest pose deviation per sweep "
          f"{[float(f'{d:.3g}') for d in cpu_dev]} "
          f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
    if not cpu_dev.max() <= IMU_TOL:
        raise AssertionError(f"IMU run against the CPU: {cpu_dev.max()} > {IMU_TOL}")
    return launches, (np.concatenate(live_rows), live_launches,
                      [1e3 * x for x in lat]), {
        "sweeps": n, "dynamic_vs_static_max_dev": dyn_dev,
        "live_ate_m": ate, "live_p50_ms": ms[len(ms) // 2], "live_max_ms": ms[-1],
        "live_slowest_sweep": slowest,
        "live_slowest_events": live.live_events[slowest],
        "live_ms": [1e3 * x for x in lat],
        "surround_maps": live.surround_count, "archive_reinstated": reinstated,
        "resume_max_dev": res_dev, "imu_moved_max": imu_moved,
        "imu_vs_cpu_max_dev": float(cpu_dev.max())}


def _cli(argv: list) -> dict:
    """Run the loam-torch command in this process; returns its report
    (the JSON object it printed), which is also printed here."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        print(f"loam-torch {argv[0]}: {' '.join(buf.getvalue().split())}",
              flush=True)
    return json.loads(buf.getvalue())


class _TrackedDriver(LoamDriver):
    """LoamDriver that keeps every instance, so that a command's driver
    can be read after the command."""
    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _TrackedDriver.made.append(self)


@contextlib.contextmanager
def _tracked_driver():
    _TrackedDriver.made = []
    driver_mod.LoamDriver = _TrackedDriver
    try:
        yield _TrackedDriver.made
    finally:
        driver_mod.LoamDriver = LoamDriver


def engine_calls(calls: dict, label: str, timed=tuple(WRAPPERS)) -> dict:
    """Each recorded call against the plain version (bit-equal) and, for
    the kernels in ``timed``, its time in a CUDA graph, by kernel and by
    the shapes of its tensor arguments (K2's corner and flat calls, K3's
    corner and surf calls): the number of calls and their mean and
    largest time."""
    out = {}
    for name, args_list in calls.items():
        wrapper, plain = KERNELS[name][:2]
        groups = {}
        for i, (a, kw) in enumerate(args_list):
            got, want = wrapper(*a, **kw), plain(*a, **kw)
            got, want = _outputs(name, got), _outputs(name, want)
            _require_equal(f"{name} {label} call {i}", got, want)
            groups.setdefault(_shapes(a), []).append(
                kernel_times.graph_ms(lambda a=a, kw=kw: wrapper(*a, **kw), 10, 5)
                if name in timed else None)
        out[name] = [{"shapes": k, "calls": len(v),
                      "kernel_ms_mean": None if v[0] is None else sum(v) / len(v),
                      "kernel_ms_max": None if v[0] is None else max(v)}
                     for k, v in groups.items()]
        for o in out[name]:
            timing = ("" if o["kernel_ms_mean"] is None else
                      f"; in a graph {o['kernel_ms_mean']:.4f} ms a call (max "
                      f"{o['kernel_ms_max']:.4f})")
            print(f"{label} engine {name} [{o['shapes']}]: {o['calls']} calls, "
                  f"each bit-equal to the plain version{timing}", flush=True)
    return out


def _loss_counters(drv: LoamDriver) -> dict:
    """Every telemetry counter that counts lost points (all but
    archive_reinstated, which counts rows moved back into the map)."""
    return {k: drv.metrics.counters.get(k, 0)
            for k in LoamDriver._PACKED_COUNTERS if k != "archive_reinstated"}


def _tum_positions(path: str) -> np.ndarray:
    return np.loadtxt(path, ndmin=2)[:, 1:4]


def _write_sweeps_bag(path: str, sweeps: list, imu: bool) -> None:
    """Sweeps as /velodyne_points at 10 Hz; with ``imu`` a stationary IMU
    at 100 Hz through each sweep (tests/test_bag_pipeline.py's bag)."""
    with rosbag.BagWriter(path) as w:
        for k, pts in enumerate(sweeps):
            t = 1000.0 + 0.1 * k
            for j in range(10 if imu else 0):
                w.write_imu("/imu/data", t + 0.01 * j, (0, 0, 0, 1),
                            (0.0, 0.0, 9.81))
            w.write_cloud("/velodyne_points", t, pts)


def _same_arrays(name: str, got: list, want: list) -> None:
    if len(got) != len(want) or any(
            a.dtype != b.dtype or not np.array_equal(a, b)
            for a, b in zip(got, want)):
        raise AssertionError(f"{name}: native and Python readers differ")


def run_entry_points(dev, card: str) -> tuple[dict, dict]:
    """The port's real-data entry points on the card, through the
    loam-torch command in this process (``cli.main``) and the driver:
    the native readers against the Python ones, ``validate`` on a
    VLP-16 wire-format pcap (record, then gate), ``run --source bag`` on
    a bag with an IMU and ``run_bag``'s resume, ``run --source kitti`` at
    the HDL-64E preset with every kernel call recorded and held against
    its plain version, a live feeder over a card driver, ``profile`` and
    ``info``. The launch counts are set to 0 before the phase and read
    after it, and set to 0 again just before the HDL-64E run, whose own
    counts are read just after it (the phase's total adds both reads).
    Returns the launches and the phase's numbers."""
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "entry")
    os.makedirs(work, exist_ok=True)
    out = {}
    sync(dev)
    _zero_launches()

    # The VLP-16 wire-format pcap: validate records a golden, then gates.
    wire = os.path.join(work, "wire_vlp16.pcap")
    golden = wire + ".golden.npz"
    if os.path.exists(golden):
        os.remove(golden)
    gt = make_validation_pcap.write_validation_pcap(wire, WIRE_SWEEPS)
    rec = _cli(["validate", "--path", wire, "--ate-tol", str(GOLDEN_TOL_M)])
    gate = _cli(["validate", "--path", wire, "--ate-tol", str(GOLDEN_TOL_M)])
    if not (rec.get("recorded") and rec["sweeps"] == WIRE_SWEEPS and gate["ok"]
            and gate["ate_vs_golden_m"] <= GOLDEN_TOL_M):
        raise AssertionError(f"validate on the wire pcap: {rec} then {gate}")
    with np.load(golden) as g:
        wire_ate = ate_rmse(g["positions"], gt, align=True)
    print(f"entry points: wire pcap ({WIRE_SWEEPS} VLP-16 sweeps of 1,800 "
          f"azimuths) recorded and gated at {gate['ate_vs_golden_m']} m "
          f"(<= {GOLDEN_TOL_M}); ATE against the simulator "
          f"{wire_ate * 100:.3f} cm", flush=True)
    if not wire_ate < ATE_GATE_M:
        raise AssertionError(f"wire pcap ATE {wire_ate:.4f} m")
    out["wire_pcap"] = {"ate_vs_golden_m": gate["ate_vs_golden_m"],
                        "ate_m": wire_ate, "sweeps_per_sec": gate["sweeps_per_sec"]}

    # A rosbag with an IMU through `run --source bag`.
    sweeps, bag_gt, _ = synthetic.generate_sequence(BAG_SWEEPS, n_azimuth=900,
                                                    speed=1.0)
    bag = os.path.join(work, "imu.bag")
    _write_sweeps_bag(bag, sweeps, imu=True)
    tum = os.path.join(work, "imu.tum")
    rep = _cli(["run", "--source", "bag", "--path", bag, "--out-traj", tum])
    bag_ate = ate_rmse(_tum_positions(tum), bag_gt, align=True)
    print(f"entry points: bag with IMU, {rep['sweeps']} sweeps, ATE "
          f"{bag_ate * 100:.3f} cm", flush=True)
    if rep["sweeps"] != BAG_SWEEPS or not bag_ate < BAG_ATE_GATE_M:
        raise AssertionError(f"bag run: {rep}, ATE {bag_ate:.4f} m")
    out["bag"] = {"sweeps": rep["sweeps"], "ate_m": bag_ate,
                  "sweeps_per_sec": rep["sweeps_per_sec"]}

    # The native readers equal the Python readers on these files.
    if native.load() is None:
        raise AssertionError("the native reader library did not build")
    _same_arrays("pcap", pcap.read_pcap_sweeps(wire, None, native=True)[0],
                 pcap.read_pcap_sweeps(wire, None, native=False)[0])
    nat = list(rosbag.read_messages(bag, native=True))
    py = list(rosbag.read_messages(bag, native=False))
    if [m[:2] for m in nat] != [m[:2] for m in py]:
        raise AssertionError("bag: native and Python readers differ")
    _same_arrays("bag", [m[2] for m in nat], [m[2] for m in py])
    print(f"entry points: native readers built ({native._LIB}) and equal the "
          f"Python readers bit for bit on the pcap and the bag", flush=True)

    # run_bag's resume: a checkpoint after RESUME_AT sweeps, then the
    # whole bag; the consumed clouds are skipped.
    rsweeps, _, _ = synthetic.generate_sequence(RESUME_SWEEPS, n_azimuth=600)
    full, first = (os.path.join(work, f) for f in ("full.bag", "first.bag"))
    _write_sweeps_bag(full, rsweeps, imu=False)
    _write_sweeps_bag(first, rsweeps[:RESUME_AT], imu=False)
    cfg = LoamConfig.preset("VLP-16")
    ref = LoamDriver(cfg, dev, system_delay=0)
    ref.run_bag(full)
    ckpt = os.path.join(work, "bag_state.npz")
    LoamDriver(cfg, dev, system_delay=0, checkpoint_path=ckpt,
               checkpoint_every=1).run_bag(first)
    resumed = LoamDriver(cfg, dev, system_delay=0, checkpoint_path=ckpt)
    if not resumed.resume() or resumed.resumed_sweeps != RESUME_AT:
        raise AssertionError("run_bag resume: the checkpoint did not load")
    resumed.run_bag(full)
    if len(resumed.trajectory) != RESUME_SWEEPS - RESUME_AT:
        raise AssertionError(f"run_bag resume ran {len(resumed.trajectory)} sweeps")
    bag_res = float(np.abs(np.stack(resumed.trajectory)
                           - np.stack(ref.trajectory[RESUME_AT:])).max())
    print(f"entry points: run_bag resumed after sweep {RESUME_AT - 1} and "
          f"reproduced sweeps {RESUME_AT}-{RESUME_SWEEPS - 1}, largest pose "
          f"deviation {bag_res:.3g}", flush=True)
    if not bag_res <= RESUME_TOL:
        raise AssertionError(f"run_bag resume: {bag_res} > {RESUME_TOL}")
    out["bag_resume_max_dev"] = bag_res

    # HDL-64E through KITTI at datasheet capacities, every kernel call
    # recorded.
    hsweeps, hgt, _ = synthetic.generate_sequence(
        HDL_SWEEPS, lidar=HDL64E, n_azimuth=900, noise_std=0.005,
        traj=synthetic.turning_trajectory(speed=1.0))
    seq = os.path.join(work, "kitti", "velodyne")
    os.makedirs(seq, exist_ok=True)
    for f in os.listdir(seq):
        os.remove(os.path.join(seq, f))
    for k, pts in enumerate(hsweeps):
        kitti.write_velodyne_bin(os.path.join(seq, f"{k:06d}.bin"), pts)
    rows = np.zeros((HDL_SWEEPS, 12))
    rows[:, [0, 5, 10]] = 1.0
    rows[:, [3, 7, 11]] = hgt * [-1.0, -1.0, 1.0]     # LOAM camera -> KITTI
    poses = os.path.join(work, "kitti", "poses.txt")
    np.savetxt(poses, rows)
    sync(dev)
    phase_launches = _read_launches()       # the phase's total so far
    _zero_launches()
    with _tracked_driver() as made, _recording_calls() as calls:
        rep = _cli(["run", "--source", "kitti", "--path", seq, "--lidar",
                    "HDL-64E", "--gt-poses", poses, "--sweeps", str(HDL_SWEEPS)])
    sync(dev)
    hdl_launches = _read_launches()
    drv = made[0]
    losses = _loss_counters(drv)
    step_ms = 1e3 * float(np.mean(drv.step_times))
    finite = bool(np.isfinite(np.stack(drv.trajectory)).all())
    print(f"entry points: HDL-64E KITTI run, {rep['sweeps']} sweeps, ATE "
          f"{rep['ate_m'] * 100:.2f} cm, RPE {rep['rpe_m'] * 100:.2f} cm, "
          f"loss counters {losses}, {step_ms:.1f} ms a sweep; launches per "
          f"sweep {json.dumps({k: v / HDL_SWEEPS for k, v in hdl_launches.items()})}"
          f", card: {card}", flush=True)
    if rep["sweeps"] != HDL_SWEEPS or not finite or any(losses.values()):
        raise AssertionError(f"HDL-64E run: {rep}, losses {losses}, finite {finite}")
    if not rep["ate_m"] <= ATE_GATE_M:
        raise AssertionError(f"HDL-64E ATE {rep['ate_m']} m above {ATE_GATE_M}")
    if any(len(calls[k]) != hdl_launches[k] for k in calls):
        raise AssertionError(f"recorded calls {[len(v) for v in calls.values()]}"
                             f" against launches {hdl_launches}")
    out["hdl64e"] = {"sweeps": rep["sweeps"], "ate_m": rep["ate_m"],
                     "rpe_m": rep["rpe_m"], "ms_per_sweep": step_ms,
                     "launches": hdl_launches,
                     "archive_reinstated":
                         drv.metrics.counters.get("archive_reinstated", 0)}
    del made[:], drv

    # HDL-32 through the simulator source at datasheet capacities.
    with _tracked_driver() as made:
        rep = _cli(["run", "--lidar", "HDL-32", "--sweeps", str(HDL_SWEEPS)])
    losses = _loss_counters(made[0])
    print(f"entry points: HDL-32 simulator run, {rep['sweeps']} sweeps, ATE "
          f"{rep['ate_m'] * 100:.2f} cm, loss counters {losses}", flush=True)
    if (rep["sweeps"] != HDL_SWEEPS or any(losses.values())
            or not np.isfinite(np.stack(made[0].trajectory)).all()
            or not rep["ate_m"] <= ATE_GATE_M):
        raise AssertionError(f"HDL-32 run: {rep}, losses {losses}")
    out["hdl32"] = {"sweeps": rep["sweeps"], "ate_m": rep["ate_m"],
                    "sweeps_per_sec": rep["sweeps_per_sec"]}
    del made[:]

    # A live feeder over a card driver: a sensor thread at 10 Hz.
    cfg = LoamConfig.preset("VLP-16")
    fx, fm, _ = synthetic.bench_sequence(FEED_SWEEPS, cfg.lidar, SWEEP_CAP)
    feed = LiveFeeder(LoamDriver(cfg, dev, sweep_capacity=SWEEP_CAP,
                                 system_delay=0))

    def sensor():
        for k in range(FEED_SWEEPS):
            feed.push(fx[k][fm[k]], stamp=0.1 * k)
            time.sleep(0.1)
        feed.stop()

    producer = threading.Thread(target=sensor)
    t0 = time.perf_counter()
    producer.start()
    feed.spin(timeout=120.0)
    producer.join(timeout=120.0)
    st = feed.stats
    feed_ms = [1e3 * x for x in feed.driver.step_times]
    print(f"entry points: live feeder, {json.dumps(st)} in "
          f"{time.perf_counter() - t0:.1f} s; {np.mean(feed_ms):.1f} ms a "
          f"processed sweep against 100 ms between sweeps", flush=True)
    if (producer.is_alive() or st["pushed"] != FEED_SWEEPS
            or st["pushed"] != st["processed"] + st["dropped"] + st["queued"]
            or st["processed"] < 2):
        raise AssertionError(f"live feeder: {st}")
    out["live_feeder"] = {**st, "ms_per_processed_sweep": float(np.mean(feed_ms))}

    # profile writes a trace; info lists the card.
    trace = os.path.join(work, "trace")
    prof = _cli(["profile", "--sweeps", "2", "--warmup", "1", "--out", trace])
    info = _cli(["info"])
    if not os.path.getsize(os.path.join(trace, "trace.json")):
        raise AssertionError("profile wrote no trace")
    if not any(d.startswith("cuda:0") for d in info["devices"]):
        raise AssertionError(f"info lists no CUDA device: {info}")
    out["profile_mean_step_ms"] = prof["mean_step_ms"]

    sync(dev)
    launches = {k: v + phase_launches[k] for k, v in _read_launches().items()}
    print(f"entry-point kernel launches: {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the entry points: {missing}")
    # After the counts are read: every HDL-64E kernel call against its
    # plain version, and its time in a graph.
    out["hdl64e"]["engine_calls"] = engine_calls(calls, "HDL-64E")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"entry points: the phase took {out['seconds']:.1f} s", flush=True)
    return launches, out


def sized_config() -> tuple[LoamConfig, int]:
    """The VLP-16 preset sized to the bench stream: its first
    SIZED_SWEEPS sweeps' padding (``config.stream_cap``) and
    ``LoamConfig.sized_for_stream`` of it, as the JAX bench sizes its
    cells: (config, sweep padding)."""
    cfg = LoamConfig.preset("VLP-16")
    cap = stream_cap(synthetic.bench_sweeps(SIZED_SWEEPS, cfg.lidar)[0])
    return cfg.sized_for_stream(cap), cap


def _expected_launches(sweeps: int) -> dict:
    """Each kernel's launches over ``sweeps`` sweeps of the static
    cadence from the start: K1 once and K2 twice a sweep, K3 10 times an
    odometry sweep, K4 10 times a mapping frame (every second sweep)."""
    return {"grid_windows": sweeps, "greedy_pick_rows": 2 * sweeps,
            "corresp_search": 10 * (sweeps - 1),
            "grouped_window_knn": 10 * (sweeps // 2)}


def run_multiprocess(dev, card: str) -> dict:
    """The multi-process replay (``parallel/multihost.py``) on the card,
    through its dry run (``tools/dryrun_dcn.py --device cuda --preset
    VLP-16``): two fresh processes on ``cuda:0``, two lanes each (lane 0
    the bench sequence in both, lane 1 each rank's own), one all_gather
    at the end. Each worker counts its kernels' launches from 0 over its
    run (every lane form, exact). The two workers' gathered arrays must
    be equal, lane 0 of both ranks bit-equal, and every gathered lane
    bit-equal to each rank's two lanes replayed here through
    the eager batched chunk at B = 2 after the workers have exited (alone
    on the card; the workers run the CUDA graphs, so this holds graphed
    lanes to eager ones), whose ATE and loss counters are gated. The
    workers' graphs skip the GN phases after the stop on the card: each
    worker's launches, counted on its card, are those this process's
    eager run of its lanes needed (``launch_counts.needed``). All
    readings are printed before any gate is applied."""
    t_phase = time.perf_counter()
    os.makedirs(os.path.dirname(MULTI_REPORT), exist_ok=True)
    rc = dryrun_dcn.main(["--device", dev.type, "--preset", MULTI_PRESET,
                          "--out", MULTI_REPORT,
                          "--timeout", str(MULTI_TIMEOUT_S)])
    if rc != 0:
        raise AssertionError(f"multi-process: the dry run exited {rc}")
    # This process's own B = 2 run of each rank's lanes.
    own, own_secs, ates, losses, own_needed = [], [], [], [], []
    for rank in range(dryrun_dcn.N_PROC):
        case = dryrun_dcn.CASES[MULTI_PRESET](rank)
        if case.chunk != CHUNK:
            raise AssertionError(f"the dry run's chunk {case.chunk} is "
                                 f"not {CHUNK}")
        xyz, mask = zip(*(synthetic.pad_sweeps(lane, case.cap)
                          for lane in case.lanes))
        with launch_counts.needed() as needed:
            packed, secs = _batched_replay(
                case.cfg, torch.from_numpy(np.stack(xyz)).to(dev),
                torch.from_numpy(np.stack(mask)).to(dev))
        own_needed.append(_needed(needed))
        own.append(packed[:, :, 15:18])
        own_secs.append(secs)
        ates += [ate_rmse(packed[i, :, 15:18], gt, align=True)
                 for i, gt in enumerate(case.gts)]
        losses.append(packed[:, :, 20:27].sum(axis=(0, 1)))
    with open(MULTI_REPORT) as f:
        report = json.load(f)
    workers = report["workers"]
    gathered = np.asarray(workers[0]["positions"], np.float32)
    eager = _expected_launches(gathered.shape[1])
    expected = own_needed
    for w in workers:
        print(f"multi-process: rank {w['rank']} on {w['device']} "
              f"({w['card']}): {w['sweeps']} sweeps x {w['lanes']} lanes in "
              f"{w['seconds']:.1f} s, chunk seconds "
              f"{[round(x, 2) for x in w['chunk_seconds']]}; lane-form "
              f"launches {json.dumps(w['launches'])} (expected "
              f"{json.dumps(expected[w['rank']])}, eager "
              f"{json.dumps(eager)}); card: {card}", flush=True)
    own = np.concatenate(own)
    lanes_equal = [bool(np.array_equal(gathered[i], own[i]))
                   for i in range(len(own))]
    losses = np.sum(losses, axis=0)
    out = {"processes": report["processes"], "lanes": report["lanes"],
           "sweeps": report["sweeps"],
           "gathered_equal": report["gathered_equal"],
           "lane0_max_abs_diff": report["lane0_max_abs_diff"],
           "lanes_equal_to_this_process": lanes_equal,
           "lanes_max_abs_diff_to_this_process": float(np.abs(gathered - own).max()),
           "ate_m": ates, "loss_counters": losses.tolist(),
           "this_process_chunk_seconds": own_secs,
           "workers": [{k: w[k] for k in ("rank", "device", "card", "seconds",
                                          "chunk_seconds", "launches")}
                       for w in workers],
           "dry_run_seconds": report["seconds"]}
    print(f"multi-process: {out['processes']} processes, {out['lanes']} lanes "
          f"gathered in each, equal across them: {out['gathered_equal']}; lane 0 "
          f"of rank 0 against rank 1: {out['lane0_max_abs_diff']:.3g}; each "
          f"lane bit-equal to this process's B = 2 run: {lanes_equal} (largest "
          f"difference {out['lanes_max_abs_diff_to_this_process']:.3g}; its "
          f"chunk seconds alone on the card, by rank "
          f"{[[round(x, 2) for x in v] for v in own_secs]}); ATE by lane "
          f"{[round(100 * a, 3) for a in ates]} cm, loss counters "
          f"{losses.tolist()}", flush=True)
    failures = []
    want_card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
    for w in workers:
        if not (w["device"].startswith(dev.type) and w["card"] == want_card
                and w["launches"] == expected[w["rank"]]):
            failures.append(f"rank {w['rank']}: {w['device']} {w['card']}, "
                            f"launches {w['launches']}, expected "
                            f"{expected[w['rank']]}")
    if not (out["gathered_equal"] and out["lane0_max_abs_diff"] == 0.0
            and all(lanes_equal)):
        failures.append("the gathered lanes differ")
    if max(ates) > ATE_GATE_M or losses.any():
        failures.append(f"ATE {ates}, loss counters {losses}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"multi-process: the phase took {out['seconds']:.1f} s (the dry run "
          f"{report['seconds']:.1f} s); card: {card}", flush=True)
    if failures:
        raise AssertionError("multi-process phase: " + "; ".join(failures))
    return out


def run_sized(dev, card: str, sized: tuple, replay_chunk_ms: list
              ) -> tuple[dict, dict]:
    """The bench sequence's first SIZED_SWEEPS sweeps through
    the eager chunk at the sized config (``sized_config``), the
    sweeps padded to its stream's padding: ATE and zero loss counters,
    the launches counted from 0 (exact), every kernel call recorded and
    held bit-equal to its plain version after the counts are read, K1's
    and K2's timed in a CUDA graph; K3's and K4's shapes must be those of
    the datasheet capacities (their capacities do not follow P). The ms
    a sweep by chunk is printed beside the datasheet replay's on the same
    sweeps (``replay_chunk_ms``, earlier in this call). Returns the
    launches and the phase's numbers."""
    t_phase = time.perf_counter()
    cfg, cap = sized
    xyz, mask, gt = synthetic.bench_sequence(SIZED_SWEEPS, cfg.lidar, cap)
    xyz_d = torch.from_numpy(xyz).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    engine = Engine(cfg, dev)
    sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    with _recording_calls() as calls:
        packed, ends = replay(engine, xyz_d, mask_d)
    launches = _read_launches()
    packed = packed.cpu().numpy()
    chunk_ms = [1e3 * (b - a) / CHUNK for a, b in zip([t0] + ends, ends)]
    ate = ate_rmse(packed[:, 15:18], gt, align=True)
    losses = packed[:, 20:27].sum(axis=0)
    datasheet = {name: {_shapes(args) for case, args in
                        kernel_times.main_path_inputs(dev, SEED).items()
                        if case.startswith(prefix)}
                 for name, prefix in (("corresp_search", "corresp"),
                                      ("grouped_window_knn", "knn"))}
    shapes = {name: sorted({_shapes(a) for a, _ in calls[name]})
              for name in calls}
    print(f"sized: VLP-16 at P = {cfg.lidar.max_points_per_ring} (datasheet "
          f"{LoamConfig.preset('VLP-16').lidar.max_points_per_ring}), sweeps "
          f"padded to {cap} rows; {SIZED_SWEEPS} sweeps, ATE {ate * 100:.3f} cm, "
          f"loss counters {losses.tolist()}; launches {json.dumps(launches)}; "
          f"call shapes {json.dumps(shapes)}", flush=True)
    print(f"sized: ms a sweep by chunk {[round(v, 2) for v in chunk_ms]} against "
          f"the datasheet replay's on the same sweeps "
          f"{[round(v, 2) for v in replay_chunk_ms[:len(chunk_ms)]]} (its first "
          f"chunk is this call's first); card: {card}", flush=True)
    failures = []
    if launches != _expected_launches(SIZED_SWEEPS):
        failures.append(f"launches {launches}")
    if not (np.isfinite(packed).all() and ate <= ATE_GATE_M) or losses.any():
        failures.append(f"ATE {ate}, loss counters {losses}")
    for name, want in datasheet.items():
        if not set(shapes[name]) <= want:
            failures.append(f"{name} shapes {shapes[name]}, datasheet {want}")
    if failures:
        raise AssertionError("sized phase: " + "; ".join(failures))
    out = {"p_cap": cfg.lidar.max_points_per_ring, "sweep_cap": cap,
           "sweeps": SIZED_SWEEPS, "ate_m": ate, "launches": launches,
           "ms_per_sweep_by_chunk": chunk_ms,
           "datasheet_ms_per_sweep_same_sweeps": replay_chunk_ms[:len(chunk_ms)],
           "engine_calls": engine_calls(calls, "sized",
                                        ("grid_windows", "greedy_pick_rows"))}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"sized: the phase took {out['seconds']:.1f} s", flush=True)
    return launches, out


def oracle_gates(dev) -> tuple[dict, list]:
    """tests/test_oracle.py's VLP-16 gates for the port's driver:
    ``LoamDriver(cfg, dev, system_delay=0).run`` on 30 noisy turning
    sweeps (the 10-sweep gate's input is their first 10: each sweep's
    noise comes from its own seed, and the driver goes sweep by sweep)
    against the NumPy oracle's fused poses (ORACLE_NPZ). Returns the
    readings by sweep count and the gates that failed."""
    cfg = LoamConfig.preset("VLP-16")
    sweeps, _ = synthetic.bench_sweeps(max(ORACLE_SWEEPS), cfg.lidar)
    est = LoamDriver(cfg, dev, system_delay=0).run(sweeps)
    readings, failed = {}, []
    with np.load(ORACLE_NPZ) as ref:
        for n in ORACLE_SWEEPS:
            oracle, gt = ref[f"fused_{n}"][:, 3:], ref[f"gt_{n}"]
            r = readings[n] = {
                "cross_ate_m": ate_rmse(est[:n], oracle, align=True),
                "cross_rpe_m": rpe_rmse(est[:n], oracle),
                "port_ate_m": ate_rmse(est[:n], gt, align=True),
                "oracle_ate_m": ate_rmse(oracle, gt, align=True)}
            if not (np.isfinite(est[:n]).all() and r["cross_ate_m"] < ORACLE_CROSS_M
                    and r["port_ate_m"] < ORACLE_GT_M
                    and r["oracle_ate_m"] < ORACLE_GT_M):
                failed.append(f"{n} sweeps: {r}")
            if n == max(ORACLE_SWEEPS) and not (
                    r["cross_rpe_m"] < ORACLE_CROSS_M
                    and r["port_ate_m"] < ORACLE_RATIO * r["oracle_ate_m"]):
                failed.append(f"{n} sweeps, RPE and ratio: {r}")
    return readings, failed


def run_oracle(dev, card: str) -> tuple[dict, dict]:
    """The oracle gates on the card (``oracle_gates``), with the launch
    counts set to 0 before and read after: K1 once and K2 twice a sweep,
    K3 and K4 as the dynamic GN stops. Returns the launches and the
    readings."""
    t_phase = time.perf_counter()
    n = max(ORACLE_SWEEPS)
    sync(dev)
    _zero_launches()
    readings, failed = oracle_gates(dev)
    launches = _read_launches()
    for k, r in readings.items():
        print(f"oracle: {k} sweeps, the card's driver against the NumPy oracle: "
              f"ATE {r['cross_ate_m'] * 100:.3f} cm, RPE "
              f"{r['cross_rpe_m'] * 100:.3f} cm; against the ground truth, the "
              f"port {r['port_ate_m'] * 100:.3f} cm, the oracle "
              f"{r['oracle_ate_m'] * 100:.3f} cm; card: {card}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"oracle: launches {json.dumps(launches)} over {n} sweeps; the phase "
          f"took {seconds:.1f} s", flush=True)
    if not (launches["grid_windows"] == n and launches["greedy_pick_rows"] == 2 * n
            and launches["corresp_search"] > 0 and launches["grouped_window_knn"] > 0):
        failed.append(f"launches {launches}")
    if failed:
        raise AssertionError("oracle phase: " + "; ".join(failed))
    return launches, {"readings": {str(k): v for k, v in readings.items()},
                      "launches": launches, "seconds": seconds}


@contextlib.contextmanager
def _eager_batched_chunks():
    """Inside the block ``make_batched_chunk`` returns the eager batched
    chunk, so a phase's recorders see every lane-form call its callers
    make (a graph replays without Python)."""
    graphed = replay_mod.make_batched_chunk

    def eager(cfg, with_imu=False, static_cadence=True):
        if not static_cadence:
            return graphed(cfg, with_imu, static_cadence)
        return replay_mod.make_eager_batched_chunk(cfg, with_imu)

    replay_mod.make_batched_chunk = eager
    try:
        yield
    finally:
        replay_mod.make_batched_chunk = graphed


def run_bench(dev, card: str) -> tuple[dict, dict]:
    """The port's bench (``loam_velodyne_torch/bench.py``) with
    ``--headline-only`` at BENCH_SWEEPS sweeps and B = BENCH_LANES, in
    this process on ``dev``, with the launch counts set to 0 before and
    read after: the line (printed by the bench) must have the JAX
    bench's headline keys (BENCH_LATEST.json), finite positive rates,
    ATE <= 5 cm and zero telemetry; each kernel must have launched
    single-lane (the single stream and the live driver) and as a lane
    form at B = BENCH_LANES (the identical and distinct batched
    replays), K1 and K2 exactly once and twice a sweep of each of the
    four runs and of the live driver's warm-up sweeps
    (``bench.LIVE_WARM_SWEEPS``), K3 and K4 at B = BENCH_LANES as the
    static cadence implies. Every lane-form call of the run (single-lane calls are the
    lane form at B = 1) is recorded and held bit-equal to its plain twin
    afterwards (``batched_calls``), so the sized shapes the bench reads
    its rates from are checked at both lane counts. The recording clones
    each call's arguments inside the timed loops, so the phase's rates
    are not the bench's. Returns the launches and the phase's numbers."""
    t_phase = time.perf_counter()
    with open(BENCH_LATEST) as f:
        want = json.load(f)["lines"][0]
    sync(dev)
    _zero_launches()
    with _eager_batched_chunks(), _recording_lane_calls() as calls:
        lines = port_bench.main([str(BENCH_SWEEPS), str(BENCH_LANES),
                                 "--headline-only", "--device", str(dev)])
    launches = _read_launches()
    line = lines[0]
    extra = line["extra"]
    n = BENCH_SWEEPS
    by_lanes = {k: [a[0].shape[0] for a in calls[k + "_lanes"]]
                for k in WRAPPERS}
    lane_calls = {k: v.count(BENCH_LANES) for k, v in by_lanes.items()}
    single_calls = {k: v.count(1) for k, v in by_lanes.items()}
    expected_lane = {k: 2 * v for k, v in _expected_launches(n).items()}
    out = {"line": line, "launches": launches, "lane_calls": lane_calls,
           "single_lane_calls": single_calls,
           "bench_seconds": time.perf_counter() - t_phase}
    print(f"bench: {n} sweeps, B = {BENCH_LANES}, every kernel call recorded: "
          f"{line['value']} sweeps/s over distinct lanes, "
          f"{extra['batched_sweeps_per_sec']} identical, single stream "
          f"{extra['single_stream_sweeps_per_sec']}, live p50 "
          f"{extra['live_step_ms_p50']} ms, ATE {extra['ate_aligned_m']} m; "
          f"launches {json.dumps(launches)}, of them at B = {BENCH_LANES} "
          f"{json.dumps(lane_calls)} and single-lane {json.dumps(single_calls)}; "
          f"the bench took {out['bench_seconds']:.1f} s; card: {card}",
          flush=True)
    failures = []
    missing = port_bench.key_paths(want) ^ port_bench.key_paths(line)
    if missing or line["metric"] != want["metric"]:
        failures.append(f"keys differ from the JAX line: {sorted(missing)}")
    rates = [line["value"], extra["batched_sweeps_per_sec"],
             extra["single_stream_sweeps_per_sec"], extra["live_step_ms_p50"]]
    if not all(np.isfinite(r) and r > 0 for r in rates):
        failures.append(f"rates {rates}")
    if not extra["ate_aligned_m"] <= ATE_GATE_M or any(extra["telemetry"].values()):
        failures.append(f"ATE {extra['ate_aligned_m']}, telemetry "
                        f"{extra['telemetry']}")
    # The single stream's and the live line's sweeps, and the live line's
    # warm-up sweeps (its throwaway driver).
    single = 2 * n + port_bench.LIVE_WARM_SWEEPS
    expected_single = {"grid_windows": single, "greedy_pick_rows": 2 * single}
    if lane_calls != expected_lane or any(
            single_calls[k] != v for k, v in expected_single.items()):
        failures.append(f"calls at B = {BENCH_LANES} {lane_calls} (expected "
                        f"{expected_lane}), single-lane {single_calls}")
    if any(v == 0 for v in single_calls.values()) or launches != {
            k: lane_calls[k] + single_calls[k] for k in launches}:
        failures.append(f"launches {launches}: not every call launched")
    if failures:
        raise AssertionError("bench phase: " + "; ".join(failures))
    out["calls"] = batched_calls(calls)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"bench: every call bit-equal to its plain twin; the phase took "
          f"{out['seconds']:.1f} s", flush=True)
    return launches, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = engine_card()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {_nvcc_version()}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda:0")
    floor_ms = launch_floor(dev)
    sized = sized_config()
    kernels = check_kernels(dev, sized)
    (launches, greedy_calls, replay_packed, chunk_ms, rate,
     replay_needed) = run_engine(dev, card)
    cfg = LoamConfig.preset("VLP-16")
    seq = synthetic.bench_sequence(LIVE_SWEEPS, cfg.lidar, SWEEP_CAP)
    # The phases that count or record kernel calls step the eager path:
    # on the card Engine.step replays graphs, which run without Python.
    with device_split.eager_steps():
        per_sweep_launches, live_ref, per_sweep = run_per_sweep(
            dev, card, cfg, *seq, replay_packed)
    # Like with like: the mean over the same sweeps, after the first chunk.
    live_mean = float(np.mean(per_sweep["live_ms"][CHUNK:]))
    replay_mean = float(np.mean(chunk_ms[1:LIVE_SWEEPS // CHUNK]))
    print(f"per-sweep live with IMU, sweeps {CHUNK}-{LIVE_SWEEPS - 1}: mean "
          f"{live_mean:.2f} ms a sweep; the replay on the same sweeps: "
          f"{replay_mean:.2f} ms a sweep", flush=True)
    per_sweep.update(live_mean_ms_after_first_chunk=live_mean,
                     replay_mean_ms_same_sweeps=replay_mean)
    with device_split.eager_steps():
        entry_launches, entry = run_entry_points(dev, card)
        gates = run_trajectory_gates(dev, replay_packed)
    batched, distinct = run_batched(dev, card, replay_packed, chunk_ms)
    graph_launches, graph = run_graph(dev, card, replay_packed, chunk_ms,
                                      replay_needed, distinct,
                                      batched["sweeps_per_sec"])
    sweep_graph_launches, sweep_graph = run_sweep_graphs(
        dev, card, cfg, seq[0], seq[1], live_ref)
    multi = run_multiprocess(dev, card)
    sized_launches, sized_out = run_sized(dev, card, sized, chunk_ms)
    with device_split.eager_steps():
        oracle_launches, oracle = run_oracle(dev, card)
        print(f"before the bench phase: {time.perf_counter() - t0:.1f} s "
              f"since the build began", flush=True)
        bench_launches, bench_out = run_bench(dev, card)
    for row in kernels:
        kernel = row["name"].removesuffix("_lanes")
        row["bench"] = {"launches": bench_launches[kernel],
                        "calls_at_b1": bench_out["single_lane_calls"][kernel],
                        f"calls_at_b{BENCH_LANES}": bench_out["lane_calls"][kernel],
                        "calls": bench_out["calls"][kernel + "_lanes"]}
        run = "batched" if row["name"].endswith("_lanes") else "single"
        row["graph"] = {"launches": graph_launches[run][kernel],
                        "eager_launches": graph[run]["eager_launches"][kernel]}
        if row["name"].endswith("_lanes"):
            n = (batched["identical_launches"][kernel]
                 + batched["distinct_launches"][kernel])
            row["launches"] = n
            row["launches_per_batched_sweep"] = n / (2 * LANE_SWEEPS)
            row["batched_calls"] = batched["calls"][row["name"]]
            row["multiprocess"] = {"launches_by_rank": [
                w["launches"][kernel] for w in multi["workers"]]}
            continue
        row["sized"] = {"launches": sized_launches[row["name"]],
                        "engine_calls": sized_out["engine_calls"][row["name"]]}
        row["oracle"] = {"launches": oracle_launches[row["name"]]}
        if row["name"] == "greedy_pick_rows":
            row["engine"] = engine_greedy(greedy_calls)
        row["launches"] = launches[row["name"]]
        row["launches_per_sweep"] = launches[row["name"]] / N_SWEEPS
        row["per_sweep_path"] = {
            "launches": per_sweep_launches[row["name"]],
            "launches_per_sweep": per_sweep_launches[row["name"]]
            / per_sweep["sweeps"]}
        row["entry_points"] = {"launches": entry_launches[row["name"]]}
        row["per_sweep_graphs"] = {
            run: {"launches": v[row["name"]],
                  "launches_per_sweep": v[row["name"]] / LIVE_SWEEPS}
            for run, v in sweep_graph_launches.items()}
        row["hdl64e"] = {
            "launches_per_sweep": entry["hdl64e"]["launches"][row["name"]]
            / HDL_SWEEPS,
            "engine_calls": entry["hdl64e"]["engine_calls"][row["name"]]}
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms,
                      "replay_ms_per_sweep_by_chunk": chunk_ms,
                      "per_sweep": per_sweep, "entry_points": entry,
                      "trajectory_gates": gates,
                      "batched": {k: v for k, v in batched.items()
                                  if k != "calls"},
                      "graph": graph, "sweep_graphs": sweep_graph,
                      "multiprocess": multi,
                      "sized": {k: v for k, v in sized_out.items()
                                if k != "engine_calls"},
                      "oracle": oracle,
                      "bench": {**{k: v for k, v in bench_out.items()
                                   if k not in ("launches", "calls")},
                                "segment_sum_lanes":
                                    bench_out["calls"]["segment_sum_lanes"]},
                      "segment_sum_lanes": batched["calls"]["segment_sum_lanes"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
