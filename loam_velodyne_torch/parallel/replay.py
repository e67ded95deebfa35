"""Batched replay: B independent sequences as B lanes of one op stream.

Counterpart of ``loam_velodyne_tpu/parallel/replay.py``. The engine
step is a function of (state, sweep), so B sequences replay as the
single-lane engine under ``torch.func.vmap``: every operation runs once
for all B lanes, and every kernel runs its lane form (``ops/lanes.py``),
one launch for all lanes. The single-lane code stays the only statement
of the algorithm.

The host's cadence (``models/engine.py::Cadence``) decides which sweeps
map; it is a function of the sweep counters alone, so one host cadence
drives every lane when all lanes start at the same sweep, as one trace
drives the JAX package's vmap. Only the static cadence and the static
Gauss-Newton schedules are vmappable: the dynamic schedules leave
their loops on a flag read from the device for each lane
(``models/odometry.py::run_gauss_newton``,
``models/mapping.py::optimize_pose``), which a vmapped function cannot
read.

The vmapped calls run with the vmap fallback switched off: an operation
without a batching rule raises instead of running lane by lane.

On the card ``make_batched_chunk``'s callable replays the vmapped group
of io_ratio sweeps as CUDA graphs (``models/graph.py``), the
counterpart of the JAX package's ``jax.jit(jax.vmap(chunk_one))``: a
GN phase or iteration there is a conditional node that runs while any
lane runs (``models/conditional.py::running``, whose vmap rule reduces
over the lanes), as the vmapped ``lax.while_loop`` over phases does;
``make_eager_batched_chunk`` is the same chunk op by op, the plain
reference (the CPU runs it).

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
    """The host cadence of a batched state (one read from its device);
    every lane must be at the same sweep with the same counters."""
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
    """B sequences x K sweeps per call: vmap over the lanes of
    ``engine.run_chunk(static_cadence=True)``.

    Returns ``chunk(states, raws, cadence=None, imu_windows=None) ->
    (states, outputs)``: ``states`` batched (``stack_states``), ``raws``
    a RawSweep of (B, K, N, 3) / (B, K, N), with ``with_imu`` an ImuWindow
    with leading (B, K) axes; outputs carry leading (B, K) axes.
    ``cadence`` is the lanes' common host cadence at the chunk start;
    None reads it from the states (one read) and checks that all lanes
    share it. The chunk must start on an io_ratio boundary. Only the
    static cadence is supported (``static_cadence=False`` raises). On
    the card the chunk runs as CUDA graphs of one vmapped group
    (``chunk.graphs``, a ``models/graph.py`` ``ChunkGraphs``); on the
    CPU it is ``make_eager_batched_chunk``'s."""
    if not static_cadence:
        raise ValueError(
            "the batched replay runs the static cadence only: the dynamic "
            "Gauss-Newton schedules leave their loops on a flag read from "
            "the device for each lane, which a vmapped function cannot read")
    eager = make_eager_batched_chunk(cfg, with_imu)

    def group(cadence: Cadence):
        return lambda s, x, m, w: _vmapped_chunk(cfg, s, x, m, w, cadence)

    graphs = graph_mod.ChunkGraphs(cfg, group, sweep_axis=1)

    def chunk(states, raws: RawSweep, cadence: Optional[Cadence] = None,
              imu_windows: Optional[imu_ops.ImuWindow] = None):
        if raws.xyz.device.type != "cuda":
            return eager(states, raws, cadence, imu_windows)
        _check_imu(with_imu, imu_windows)
        if cadence is None:
            cadence = lanes_cadence(states)
        engine_mod.check_static_chunk(cfg, raws.xyz.shape[1], cadence)
        return graphs(states, raws.xyz, raws.mask, imu_windows, cadence)

    chunk.graphs = graphs
    return chunk


def make_batched_step(cfg: LoamConfig, with_imu: bool = False):
    """One sweep of B lanes: vmap over ``engine.step`` with the mapping
    mode ("on" / "off") taken from the host cadence's gate and the
    static GN schedules (the JAX package's batched step runs its
    dynamic schedules under vmap; the port's dynamic schedules read the
    device, see the module docstring).

    Returns ``step(states, raw, cadence=None, imu_window=None) ->
    (states, outputs)``: ``raw`` a RawSweep of (B, N, 3) / (B, N), with
    ``with_imu`` an ImuWindow with a leading B axis; ``cadence`` as in
    ``make_batched_chunk``; advance it with ``cadence.advance(cfg)``."""

    def step(states, raw: RawSweep, cadence: Optional[Cadence] = None,
             imu_window: Optional[imu_ops.ImuWindow] = None):
        _check_imu(with_imu, imu_window)
        if cadence is None:
            cadence = lanes_cadence(states)
        mode = "on" if cadence.gate(cfg)[1] else "off"

        def one(s, x, m, w):
            return engine_mod.step(s, RawSweep(x, m), cfg, mode, cadence, w,
                                   static_schedule=True)

        fn = torch.func.vmap(one, in_dims=(0, 0, 0, 0 if with_imu else None))
        with no_vmap_fallback():
            return fn(states, raw.xyz, raw.mask, imu_window)

    return step


def replay_sequences(cfg: LoamConfig, sequences, device="cuda",
                     sweep_capacity: int = 32768) -> np.ndarray:
    """Replay B equal-length sweep sequences as B lanes, sweep by sweep.

    sequences: list of B lists of (N_i, 3) float32 arrays (points past
    ``sweep_capacity`` are cut). Returns fused positions (B, T, 3)."""
    device = engine_mod.require_device(device)
    b, t = len(sequences), len(sequences[0])
    if any(len(s) != t for s in sequences):
        raise ValueError("sequences must be of equal length")
    step = make_batched_step(cfg)
    states = create_states(cfg, b, device)
    cadence = Cadence()
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
        states, outs = step(states, raw, cadence)
        cadence = cadence.advance(cfg)
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
