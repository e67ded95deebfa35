"""Batched replay: B independent sequences as B lanes of one op stream.

Counterpart of ``loam_velodyne_tpu/parallel/replay.py``. The engine
step is a function of (state, sweep), so B sequences replay as the
single-lane engine under ``torch.func.vmap``: every operation runs once
for all B lanes, and every kernel runs its lane form (``ops/lanes.py``),
one launch for all lanes. The single-lane code stays the only statement
of the algorithm.

Two forms, as in the JAX package:

- **The batched step** (``make_batched_step``, ``replay_sequences``,
  ``make_batched_chunk(static_cadence=False)``): vmap over
  ``engine.lane_step``, the JAX step with ``mapping_mode="auto"``. Each
  lane takes its decisions from its own counters on the device: its
  first sweep (``odometry.step`` on the state's flag, both branches,
  each lane taking its own), its mapping gate (``engine.gate``; mapping
  runs where any lane is due and each lane keeps it only where it is
  due), and each GN runs while any lane runs. So the lanes may be at
  any sweeps: fresh sequences beside running ones, or lanes resumed
  from checkpoints at different points. On the card it replays CUDA
  graphs (``batched_step_graphed``, through ``graph.SweepGraphs``): one
  graph a sweep shape and IMU window layout, whatever the lanes'
  starts, with mapping's ``prepare`` and ``finish`` and the GN phases
  and iterations conditional nodes (``models/conditional.py``), so
  nothing is read back inside a sweep; ``make_eager_batched_step`` is
  the same step op by op, the plain reference (the CPU runs it).
- **The static chunk** (``make_batched_chunk``): vmap over
  ``engine.run_chunk(static_cadence=True)``, mapping scheduled on the
  host, which needs every lane at the same sweep on an io_ratio
  boundary (``lanes_cadence``), as the JAX package's does. On the card
  its callable replays the vmapped group of io_ratio sweeps as CUDA
  graphs (``models/graph.py``), the counterpart of the JAX package's
  ``jax.jit(jax.vmap(chunk_one))``: a GN phase or iteration there is a
  conditional node that runs while any lane runs
  (``models/conditional.py::running``, whose vmap rule reduces over the
  lanes), as the vmapped ``lax.while_loop`` over phases does;
  ``make_eager_batched_chunk`` is the same chunk op by op.

The vmapped calls run with the vmap fallback switched off: an operation
without a batching rule raises instead of running lane by lane.

Each call of ``make_batched_chunk``'s callable is a step of K sweeps of
every lane for the tracing (``utils/profiling.py``): a ``replay.chunk``
span holding the ``engine.enqueue`` span of its copies and graph
launches; a call of ``make_batched_step``'s is a ``replay.step``.

There is no mesh: this runs the lanes on one device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
from torch._C import _functorch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops import imu as imu_ops
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.utils import profiling

Tensor = torch.Tensor
Cadence = engine_mod.Cadence


def stack_states(states: Sequence[engine_mod.EngineState]
                 ) -> engine_mod.EngineState:
    """Stack B engine states into one batched state (leading axis B)."""
    return engine_mod._stack(list(states))


def lane(tree, i: int):
    """Lane i of a batched state or batched outputs."""
    if isinstance(tree, tuple):
        return type(tree)(*(lane(x, i) for x in tree))
    return tree[i]


def create_states(cfg: LoamConfig, b: int, device="cuda"
                  ) -> engine_mod.EngineState:
    """B fresh engine states, stacked."""
    return stack_states([engine_mod.EngineState.create(cfg, device)
                         for _ in range(b)])


def lanes_cadence(states: engine_mod.EngineState) -> Cadence:
    """The host cadence of a batched state (one read from its device),
    for the static chunk: every lane must be at the same sweep with the
    same counters."""
    counters = torch.stack([states.sweep, states.mapping_inputs,
                            states.odometry.initialized.to(torch.int32)], 1)
    rows = {tuple(r) for r in counters.tolist()}
    if len(rows) != 1:
        raise ValueError(f"the lanes do not share their start: counters {rows}")
    sweep, inputs, init = rows.pop()
    return Cadence(sweep, inputs, bool(init))


@contextlib.contextmanager
def no_vmap_fallback():
    """Raise on an operation without a batching rule (instead of running
    it lane by lane) inside the block."""
    was = _functorch._is_vmap_fallback_enabled()
    _functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        _functorch._set_vmap_fallback_enabled(was)


def _check_imu(with_imu: bool, imu_windows) -> None:
    if (imu_windows is not None) != with_imu:
        raise ValueError(f"with_imu={with_imu}: IMU windows "
                         f"{'missing' if with_imu else 'given'}")


def _vmapped_chunk(cfg: LoamConfig, states, xyz, mask, imu_windows,
                   cadence: Cadence):
    """``engine.run_chunk(static_cadence=True)`` vmapped over the lanes,
    with the vmap fallback off."""
    def one(state, x, m, w):
        return engine_mod.run_chunk(state, RawSweep(x, m), cfg, cadence, w,
                                    static_cadence=True)

    fn = torch.func.vmap(
        one, in_dims=(0, 0, 0, None if imu_windows is None else 0))
    with no_vmap_fallback():
        return fn(states, xyz, mask, imu_windows)


def make_eager_batched_chunk(cfg: LoamConfig, with_imu: bool = False):
    """The batched chunk op by op (vmap over ``engine.run_chunk``): the
    plain reference of ``make_batched_chunk``'s graphs, with the same
    call; the CPU runs it."""

    def chunk(states, raws: RawSweep, cadence: Optional[Cadence] = None,
              imu_windows: Optional[imu_ops.ImuWindow] = None):
        _check_imu(with_imu, imu_windows)
        if cadence is None:
            cadence = lanes_cadence(states)
        return _vmapped_chunk(cfg, states, raws.xyz, raws.mask, imu_windows,
                              cadence)

    return chunk


def make_batched_chunk(cfg: LoamConfig, with_imu: bool = False,
                       static_cadence: bool = True):
    """B sequences x K sweeps per call.

    Returns ``chunk(states, raws, cadence=None, imu_windows=None) ->
    (states, outputs)``: ``states`` batched (``stack_states``), ``raws``
    a RawSweep of (B, K, N, 3) / (B, K, N), with ``with_imu`` an ImuWindow
    with leading (B, K) axes; outputs carry leading (B, K) axes.

    ``static_cadence`` True: vmap over the lanes of
    ``engine.run_chunk(static_cadence=True)``. ``cadence`` is the lanes'
    common host cadence at the chunk start; None reads it from the
    states (one read) and checks that all lanes share it. The chunk must
    start on an io_ratio boundary. On the card the chunk runs as CUDA
    graphs of one vmapped group (``chunk.graphs``, a ``models/graph.py``
    ``ChunkGraphs``); on the CPU it is ``make_eager_batched_chunk``'s.

    ``static_cadence`` False: K sweeps of ``make_batched_step`` (the JAX
    ``run_chunk(static_cadence=False)`` under vmap), each lane from its
    own counters, so the lanes may start anywhere and K is any length;
    ``cadence`` is not read (the decisions are taken on the device)."""
    if not static_cadence:
        step = make_batched_step(cfg, with_imu)

        def dynamic(states, raws: RawSweep, cadence: Optional[Cadence] = None,
                    imu_windows: Optional[imu_ops.ImuWindow] = None):
            _check_imu(with_imu, imu_windows)
            outs = []
            for k in range(raws.xyz.shape[1]):
                win = None if imu_windows is None else imu_ops.ImuWindow(
                    *(t[:, k] for t in imu_windows))
                states, o = step(states, RawSweep(raws.xyz[:, k],
                                                  raws.mask[:, k]), win)
                outs.append(o)
            return states, engine_mod._stack(outs, 1)

        return dynamic

    eager = make_eager_batched_chunk(cfg, with_imu)

    def group(cadence: Cadence):
        return lambda s, x, m, w: _vmapped_chunk(cfg, s, x, m, w, cadence)

    graphs = graph_mod.ChunkGraphs(cfg, group, sweep_axis=1)

    def chunk(states, raws: RawSweep, cadence: Optional[Cadence] = None,
              imu_windows: Optional[imu_ops.ImuWindow] = None):
        with profiling.span("replay.chunk", step=True,
                            steps=raws.xyz.shape[1]):
            if raws.xyz.device.type != "cuda":
                with profiling.span("engine.enqueue"):
                    return eager(states, raws, cadence, imu_windows)
            _check_imu(with_imu, imu_windows)
            if cadence is None:
                cadence = lanes_cadence(states)
            engine_mod.check_static_chunk(cfg, raws.xyz.shape[1], cadence)
            with profiling.span("engine.enqueue"):
                return graphs(states, raws.xyz, raws.mask, imu_windows,
                              cadence)

    chunk.graphs = graphs
    return chunk


def _vmapped_step(cfg: LoamConfig, states, raw: RawSweep, imu_window):
    """``engine.lane_step`` vmapped over the lanes, with the vmap
    fallback off."""
    def one(state, x, m, w):
        return engine_mod.lane_step(state, RawSweep(x, m), cfg, w)

    fn = torch.func.vmap(
        one, in_dims=(0, 0, 0, None if imu_window is None else 0))
    with no_vmap_fallback():
        return fn(states, raw.xyz, raw.mask, imu_window)


def make_eager_batched_step(cfg: LoamConfig, with_imu: bool = False):
    """The batched step op by op (vmap over ``engine.lane_step``): the
    plain reference of ``make_batched_step``'s graphs, with the same
    call; the CPU runs it."""

    def step(states, raw: RawSweep,
             imu_window: Optional[imu_ops.ImuWindow] = None):
        _check_imu(with_imu, imu_window)
        return _vmapped_step(cfg, states, raw, imu_window)

    return step


def batched_step_graphed(graphs: graph_mod.SweepGraphs, cfg: LoamConfig,
                         states, raw: RawSweep,
                         imu_window: Optional[imu_ops.ImuWindow] = None):
    """One batched sweep through ``graphs``: the vmapped
    ``engine.lane_step`` as one graph per key, the sweep's shape (B
    included) and the IMU window's layout (no cadence: the lanes'
    decisions are taken on the card, so one graph serves every mix of
    lane starts). The caller's states are copied into the graph's slots
    and fresh tensors are returned, equal bit for bit to
    ``make_eager_batched_step``'s."""
    b = raw.xyz.shape[0]
    state_slot, out_slot = ("lanes_state", b), ("lanes_outputs", b)
    raw_slot = ("lanes_raw", tuple(raw.xyz.shape))
    reads = (state_slot, raw_slot)
    graphs.load(state_slot, states)
    graphs.load(raw_slot, raw)
    if imu_window is not None:
        win_slot = ("lanes_win", tuple(tuple(t.shape) for t in imu_window))
        graphs.load(win_slot, imu_window)
        reads += (win_slot,)
    graphs.run(("lanes",) + reads[1:], graph_mod.Segment(
        lambda s, r, w=None: _vmapped_step(cfg, s, r, w), reads,
        (state_slot, out_slot)))
    return graphs.take(state_slot), graphs.take(out_slot)


def make_batched_step(cfg: LoamConfig, with_imu: bool = False):
    """One sweep of B lanes: the JAX package's ``make_batched_step``,
    ``jax.jit(jax.vmap(step))`` with ``mapping_mode="auto"`` and the
    dynamic schedules. Each lane maps on its own gate, takes its own
    first-sweep branch, and each GN runs while any lane runs (see the
    module docstring), so the lanes may be at different sweeps.

    Returns ``step(states, raw, imu_window=None) -> (states, outputs)``:
    ``raw`` a RawSweep of (B, N, 3) / (B, N), with ``with_imu`` an
    ImuWindow with a leading B axis. On the card it replays the
    configuration's per-sweep graphs (``graph.sweep_graphs``, shared by
    every caller of this configuration on the card, through
    ``batched_step_graphed``); on the CPU it is
    ``make_eager_batched_step``'s."""
    eager = make_eager_batched_step(cfg, with_imu)

    def step(states, raw: RawSweep,
             imu_window: Optional[imu_ops.ImuWindow] = None):
        with profiling.span("replay.step", step=True), \
                profiling.span("engine.enqueue"):
            if raw.xyz.device.type != "cuda":
                return eager(states, raw, imu_window)
            _check_imu(with_imu, imu_window)
            return batched_step_graphed(
                graph_mod.sweep_graphs(cfg, raw.xyz.device), cfg, states,
                raw, imu_window)

    return step


def replay_sequences(cfg: LoamConfig, sequences, device="cuda",
                     sweep_capacity: int = 32768) -> np.ndarray:
    """Replay B equal-length sweep sequences as B lanes, sweep by sweep
    through ``make_batched_step``.

    sequences: list of B lists of (N_i, 3) float32 arrays (points past
    ``sweep_capacity`` are cut). Returns fused positions (B, T, 3)."""
    device = engine_mod.require_device(device)
    b, t = len(sequences), len(sequences[0])
    if any(len(s) != t for s in sequences):
        raise ValueError("sequences must be of equal length")
    step = make_batched_step(cfg)
    states = create_states(cfg, b, device)
    out = []
    for k in range(t):
        xyz = np.zeros((b, sweep_capacity, 3), np.float32)
        mask = np.zeros((b, sweep_capacity), bool)
        for i, seq in enumerate(sequences):
            pts = seq[k][:sweep_capacity]
            xyz[i, :len(pts)] = pts
            mask[i, :len(pts)] = True
        raw = RawSweep(torch.from_numpy(xyz).to(device),
                       torch.from_numpy(mask).to(device))
        states, outs = step(states, raw)
        out.append(outs.fused_pose[:, 3:])
    return torch.stack(out, 1).cpu().numpy()


def tiny_config() -> LoamConfig:
    """A miniature config for batched dry runs and CI: same code paths,
    toy shapes (the JAX package's ``tiny_config``)."""
    from loam_velodyne_torch.config import (LidarConfig, MappingConfig,
                                            OdometryConfig,
                                            RegistrationConfig)
    lidar = LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=64)
    reg = RegistrationConfig(corner_scan_cap=32, flat_scan_cap=16)
    mapping = MappingConfig(
        grid_width=5, grid_height=3, grid_depth=5,
        center_width=2, center_height=1, center_depth=2,
        recenter_margin=1, neighborhood=1,
        corner_cube_capacity=32, surf_cube_capacity=64,
        corner_stack_capacity=64, surf_stack_capacity=128,
        knn_window=64, knn_group=32,
        archive_capacity=4096, archive_append_budget=256,
        archive_reinstate_budget=256,
        min_surface_map_points=10, min_selected=10)
    odo = OdometryConfig(max_iterations=3, min_surface_points=10)
    return LoamConfig(lidar=lidar, registration=reg, odometry=odo,
                      mapping=mapping)
