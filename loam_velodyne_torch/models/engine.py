"""The sweep-step engine: ingest -> features -> odometry -> mapping -> fusion.

Counterpart of ``loam_velodyne_tpu/models/engine.py``. ``step`` is a
plain function of (state, raw sweep); the cadence decisions that the
JAX package takes with ``lax.cond`` on device (odometry's first sweep,
mapping on the io_ratio / stack_frame_num gate) are pure functions of
the state's counters, so for a single stream the host keeps a copy of
those counters (``Cadence``) and decides them without reading the
device. The device-side counters (``sweep``, ``mapping_inputs``) are
still carried, so the state matches the JAX layout and checkpoints
load both ways. ``lane_step`` takes the same decisions from those
device counters (``gate``), each lane its own under vmap: one lane of
the batched step (``parallel/replay.py::make_batched_step``), whose
lanes may be at different sweeps.

``step(mapping_mode="auto")`` is the per-sweep path (the cadence gate,
the dynamic GN schedules, an optional IMU window); "on" / "off" are the
static cadence that ``run_chunk(static_cadence=True)`` schedules.
``step_graphed`` is the per-sweep path through CUDA graphs of the same
segments (``front``, odometry's, mapping's, ``close``), each GN's
phases and iterations conditional nodes that the card skips once it
has stopped, with nothing read back inside the sweep: the counterpart
of the JAX driver's jitted step over ``lax.while_loop``; the eager
``step`` stays the plain reference it is held to. ``registered_cloud`` is the
full-resolution sweep in the map frame. ``Engine`` holds the device,
the state and the host cadence.
"""

from __future__ import annotations

import functools
import subprocess
from typing import NamedTuple, Optional, Tuple

import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import fusion as fusion_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.ops import imu as imu_ops
from loam_velodyne_torch.ops import scan as scan_mod
from loam_velodyne_torch.ops.features import SweepFeatures, extract_features
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils import math as lm

Tensor = torch.Tensor


def require_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card is an error
    (the CPU runs only when asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for off the card)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class EngineState(NamedTuple):
    odometry: odometry_mod.OdometryState
    mapping: mapping_mod.MappingState
    fusion: fusion_mod.FusionState
    sweep: Tensor            # () int32 processed-sweep counter
    mapping_inputs: Tensor   # () int32 bundles forwarded to mapping

    @staticmethod
    def create(cfg: LoamConfig, device="cuda") -> "EngineState":
        device = require_device(device)
        z = torch.zeros((), dtype=torch.int32, device=device)
        return EngineState(
            odometry=odometry_mod.OdometryState.create(cfg, device),
            mapping=mapping_mod.MappingState.create(cfg, device),
            fusion=fusion_mod.FusionState.create(device),
            sweep=z, mapping_inputs=z.clone())


class Telemetry(NamedTuple):
    """Per-sweep overflow/shed counters."""

    ingest_dropped: Tensor
    feature_dropped: Tensor
    mapping: mapping_mod.MapTelemetry


class EngineOutputs(NamedTuple):
    odom_pose: Tensor      # (6,) odometry pose
    mapped_pose: Tensor    # (6,) latest refined pose
    fused_pose: Tensor     # (6,) integrated pose
    mapping_ran: Tensor    # () bool
    surround_due: Tensor   # () bool
    telemetry: Telemetry
    # (29,) float32: odom(0:6) mapped(6:12) fused(12:18)
    # [mapping_ran, surround_due](18:20), the 8 telemetry counters
    # (20:28) in Telemetry field order, archive cursor (28).
    packed: Tensor

    @staticmethod
    def pack(odom_pose, mapped_pose, fused_pose, mapping_ran, surround_due,
             tel: Telemetry, archive_cnt) -> Tensor:
        mt = tel.mapping
        scalars = torch.stack([
            mapping_ran, surround_due, tel.ingest_dropped, tel.feature_dropped,
            mt.cube_corner_dropped, mt.cube_surf_dropped,
            mt.stack_corner_dropped, mt.stack_surf_dropped,
            mt.active_cube_deficit, mt.archive_reinstated,
            archive_cnt]).to(torch.float32)
        return torch.cat([odom_pose, mapped_pose, fused_pose, scalars])

    @staticmethod
    def unpack(p) -> "EngineOutputs":
        """One (29,) packed row read back to the host (numpy) -> outputs
        with numpy poses and Python scalars."""
        c = [int(v) for v in p[20:28]]
        tel = Telemetry(ingest_dropped=c[0], feature_dropped=c[1],
                        mapping=mapping_mod.MapTelemetry(
                            stack_corner_dropped=c[4], stack_surf_dropped=c[5],
                            cube_corner_dropped=c[2], cube_surf_dropped=c[3],
                            active_cube_deficit=c[6], archive_reinstated=c[7]))
        return EngineOutputs(odom_pose=p[0:6], mapped_pose=p[6:12],
                             fused_pose=p[12:18], mapping_ran=bool(p[18]),
                             surround_due=bool(p[19]), telemetry=tel, packed=p)


class Cadence(NamedTuple):
    """The host's copy of the state's cadence counters: sweeps processed,
    bundles forwarded to mapping, and whether odometry has seen a sweep."""

    sweep: int = 0
    mapping_inputs: int = 0
    initialized: bool = False

    def gate(self, cfg: LoamConfig) -> Tuple[bool, bool]:
        """(mapping_input, mapping_due) for the next sweep: odometry
        forwards its clouds when io_ratio < 2 or sweep % io_ratio == 1,
        never before it is initialized; mapping takes every
        stack_frame_num-th bundle, the first included."""
        io, stack = cfg.odometry.io_ratio, cfg.mapping.stack_frame_num
        mapping_input = (io < 2 or self.sweep % io == 1) and self.initialized
        due = mapping_input and (stack < 2 or self.mapping_inputs % stack == 0)
        return mapping_input, due

    def advance(self, cfg: LoamConfig) -> "Cadence":
        """The counters after one more sweep."""
        return Cadence(self.sweep + 1,
                       self.mapping_inputs + int(self.gate(cfg)[0]), True)

    @staticmethod
    def of(state: EngineState) -> "Cadence":
        """The counters of a state (one read from its device)."""
        sweep, inputs, init = torch.stack([
            state.sweep, state.mapping_inputs,
            state.odometry.initialized.to(torch.int32)]).tolist()
        return Cadence(sweep, inputs, bool(init))


class Front(NamedTuple):
    """What the front of a sweep hands on: its features, the IMU sweep
    state, the IMU's attitude at the sweep end with whether the window
    had data (zero and False without IMU windows), and the ingest's
    drop count."""

    feats: SweepFeatures
    imu: odometry_mod.ImuSweepState
    imu_rpy: Tuple[Tensor, Tensor]
    ingest_dropped: Tensor


def front(raw: scan_mod.RawSweep, imu_window: Optional[imu_ops.ImuWindow],
          cfg: LoamConfig) -> Front:
    """Ingest (K1) and features (K2), and the IMU window's summaries."""
    grid, _ = scan_mod.ingest_sweep(raw, cfg.lidar, cfg.registration, imu_window)
    feats = extract_features(grid, cfg.registration, cfg.capacities)
    if imu_window is None:
        dev = raw.xyz.device
        return Front(feats, odometry_mod.ImuSweepState.zero(dev),
                     (torch.zeros((3,), dtype=torch.float32, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev)),
                     grid.dropped)
    period = cfg.registration.scan_period
    return Front(feats, imu_ops.sweep_state(imu_window, period),
                 imu_ops.end_attitude(imu_window, period), grid.dropped)


def gate(state: EngineState, cfg: LoamConfig) -> Tuple[Tensor, Tensor]:
    """(mapping_input, mapping_due) of the next sweep as 0-d bools on the
    state's device, from its own counters: ``Cadence.gate`` computed on
    the device, the JAX step's gate (``loam_velodyne_tpu/models/
    engine.py:150-155``)."""
    io, stack = cfg.odometry.io_ratio, cfg.mapping.stack_frame_num
    mapping_input = state.odometry.initialized
    if io >= 2:
        mapping_input = mapping_input & (torch.remainder(state.sweep, io) == 1)
    due = mapping_input
    if stack >= 2:
        due = due & (torch.remainder(state.mapping_inputs, stack) == 0)
    return mapping_input, due


def close(state: EngineState, f: Front, odometry, mapped,
          mapping_input, due) -> Tuple[EngineState, EngineOutputs]:
    """The end of a sweep: fusion, the new state and the outputs.
    ``odometry``: odometry's (state, outputs); ``mapped``: mapping's
    (state, outputs) when it ran, else None. ``mapping_input`` and
    ``due``: the cadence decisions for the sweep, the host's (bools) or
    the state's own (0-d bool tensors, ``gate``): then ``mapped`` is
    every lane's mapping frame and each lane keeps it, with its fusion
    update, its surround flag and its map telemetry, only where ``due``
    holds (the JAX step's ``lax.cond`` under vmap)."""
    ostate, oouts = odometry
    dev = oouts.transform_sum.device
    if mapped is not None:
        mstate, mouts = mapped
        fstate = fusion_mod.update_mapping(state.fusion, mouts.transform_aft,
                                           mouts.transform_bef)
        surround_due, map_tel = mouts.surround_due, mouts.telemetry
    else:
        mstate, fstate = state.mapping, state.fusion
        surround_due = torch.zeros((), dtype=torch.bool, device=dev)
        map_tel = mapping_mod.MapTelemetry.zero(dev)
    if isinstance(due, Tensor):
        mstate, fstate, surround_due, map_tel = odometry_mod.select(
            due, (mstate, fstate, surround_due, map_tel),
            (state.mapping, state.fusion,
             torch.zeros((), dtype=torch.bool, device=dev),
             mapping_mod.MapTelemetry.zero(dev)))
        mapping_due = due
        forwarded = mapping_input.to(torch.int32)
    else:
        mapping_due = torch.full((), due, dtype=torch.bool, device=dev)
        forwarded = int(mapping_input)
    fused = fusion_mod.fuse(fstate, oouts.transform_sum)

    new_state = EngineState(
        odometry=ostate, mapping=mstate, fusion=fstate,
        sweep=state.sweep + 1,
        mapping_inputs=state.mapping_inputs + forwarded)
    tel = Telemetry(ingest_dropped=f.ingest_dropped,
                    feature_dropped=f.feats.dropped, mapping=map_tel)
    outs = EngineOutputs(
        odom_pose=oouts.transform_sum, mapped_pose=fstate.transform_aft,
        fused_pose=fused, mapping_ran=mapping_due, surround_due=surround_due,
        telemetry=tel,
        packed=EngineOutputs.pack(oouts.transform_sum, fstate.transform_aft,
                                  fused, mapping_due, surround_due, tel,
                                  mstate.archive_cnt))
    return new_state, outs


def step(state: EngineState, raw: scan_mod.RawSweep, cfg: LoamConfig,
         mapping_mode: str = "auto", cadence: Cadence = Cadence(),
         imu_window: Optional[imu_ops.ImuWindow] = None,
         static_schedule: bool = False
         ) -> Tuple[EngineState, EngineOutputs]:
    """Process one sweep. ``cadence``: the host's copy of the state's
    counters. ``mapping_mode`` "auto" runs mapping on the cadence gate
    (``Cadence.gate``); "on" / "off" are a cadence the caller scheduled
    ("on" requires an initialized odometry). ``imu_window``: IMU states
    with times relative to this sweep's start. ``static_schedule``: the
    fixed-phase GN schedules in odometry and mapping instead of the
    dynamic ones. It mirrors the JAX package's ``step`` argument; the
    port's callers pair it with the mode (True with "on" / "off" from
    ``run_chunk(static_cadence=True)``, False with "auto").

    The segments are those that ``step_graphed`` replays: ``front``,
    odometry (``odometry.step``), mapping when due (``mapping.step``:
    ``prepare``, the GN and ``finish``) and ``close``. This eager form,
    whose dynamic GN reads its stop flag once an iteration, is the plain
    reference the graphs are held to."""
    if mapping_mode not in ("auto", "on", "off"):
        raise ValueError(f"mapping_mode must be 'auto', 'on' or 'off', "
                         f"got {mapping_mode!r}")
    if mapping_mode == "on" and not cadence.initialized:
        raise ValueError("mapping cannot run on the first sweep")
    f = front(raw, imu_window, cfg)
    odometry = odometry_mod.step(state.odometry, f.feats, cfg,
                                 cadence.initialized, f.imu,
                                 static_schedule=static_schedule)
    mapping_input, due = cadence.gate(cfg)
    if mapping_mode != "auto":
        due = mapping_mode == "on"
    mapped = None
    if due:
        oouts = odometry[1]
        mapped = mapping_mod.step(
            state.mapping, oouts.transform_sum, oouts.corner_cloud,
            oouts.surf_cloud, cfg,
            None if imu_window is None else f.imu_rpy,
            static_schedule=static_schedule)
    return close(state, f, odometry, mapped, mapping_input, due)


def lane_step(state: EngineState, raw: scan_mod.RawSweep, cfg: LoamConfig,
              imu_window: Optional[imu_ops.ImuWindow] = None
              ) -> Tuple[EngineState, EngineOutputs]:
    """One sweep with every decision taken on the device, from the
    state's own counters (``gate``, ``state.odometry.initialized``):
    the JAX step with ``mapping_mode="auto"``, one lane of the batched
    step (``parallel/replay.py::make_batched_step`` vmaps it). The same
    segments as ``step``: ``front``; ``odometry.step`` on the state's
    flag (both branches, each lane taking its own); ``mapping.step`` on
    the gate, its ``prepare`` and ``finish`` conditional regions that
    the card skips in a sweep where no lane is due; ``close``, which
    keeps mapping's results only where the lane is due. Each GN runs
    the static schedule's phases (the dynamic schedule's transform bit
    for bit), stopped before it starts on a lane that does not run it
    and skipped on the card once no lane runs. Nothing is read back to
    the host."""
    f = front(raw, imu_window, cfg)
    odometry = odometry_mod.step(state.odometry, f.feats, cfg,
                                 state.odometry.initialized, f.imu)
    mapping_input, due = gate(state, cfg)
    oouts = odometry[1]
    mapped = mapping_mod.step(
        state.mapping, oouts.transform_sum, oouts.corner_cloud,
        oouts.surf_cloud, cfg, None if imu_window is None else f.imu_rpy,
        due=due)
    return close(state, f, odometry, mapped, mapping_input, due)


def step_graphed(graphs: graph_mod.SweepGraphs, state: EngineState,
                 raw: scan_mod.RawSweep, cfg: LoamConfig, cadence: Cadence,
                 imu_window: Optional[imu_ops.ImuWindow] = None
                 ) -> Tuple[EngineState, EngineOutputs]:
    """``step(mapping_mode="auto")`` through the per-sweep graphs
    (``graph.SweepGraphs``): the same segments, each replayed as the
    graph of its key, and each GN as the static schedule's phases (which
    give the dynamic schedule's transform bit for bit), every phase and
    every iteration after a phase's first a conditional node that the
    card skips once the GN has stopped (``models/conditional.py``), so
    nothing is read back inside the sweep. A GN's start, phases and end
    are one graph: odometry's, and mapping's prepare with its GN. A key
    holds the host's branches that its segment bakes in: the sweep's
    shape and IMU window layout (the front), odometry's first sweep, and
    the cadence decisions with the IMU (the tail). Returns fresh
    tensors, equal bit for bit to ``step``'s."""
    raw_slot = ("raw", tuple(raw.xyz.shape))
    reads = (raw_slot,)
    graphs.load("state", state)
    graphs.load(raw_slot, raw)
    if imu_window is not None:
        win_slot = ("win", tuple(tuple(t.shape) for t in imu_window))
        graphs.load(win_slot, imu_window)
        reads += (win_slot,)
    graphs.run(("front",) + reads, graph_mod.Segment(
        lambda r, w=None: (front(r, w, cfg),), reads, ("front",)))
    graphs.run(("odometry", cadence.initialized), graph_mod.Segment(
        lambda s, f: (odometry_mod.step(s.odometry, f.feats, cfg,
                                        cadence.initialized, f.imu),),
        ("state", "front"), ("odometry",)))

    mapping_input, due = cadence.gate(cfg)
    tail_reads = ("state", "front", "odometry")
    if due:
        graphs.run(("mapping",), graph_mod.Segment(
            functools.partial(_mapping_gn, cfg=cfg), ("state", "odometry"),
            ("mapping_frame", "mapping_gn")))
        tail_reads += ("mapping_frame", "mapping_gn")
    imu = imu_window is not None and due
    graphs.run(("tail", mapping_input, due, imu), graph_mod.Segment(
        functools.partial(_tail, mapping_input=mapping_input, due=due,
                          imu=imu, cfg=cfg),
        tail_reads, ("state", "outputs")))
    return graphs.take("state"), graphs.take("outputs")


def _mapping_gn(state: EngineState, odometry, cfg: LoamConfig):
    """A mapping frame up to its refined pose: ``prepare`` and the GN."""
    oouts = odometry[1]
    fr = mapping_mod.prepare(state.mapping, oouts.transform_sum,
                             oouts.corner_cloud, oouts.surf_cloud, cfg)
    targets, run = mapping_mod.gn_targets(
        fr.corner_stack, fr.surf_stack, fr.map_c_xyz, fr.map_c_mask,
        fr.map_s_xyz, fr.map_s_mask, cfg)
    return fr, mapping_mod.gn_phases(odometry_mod.gn_start(fr.tobe, run),
                                     targets, cfg)


def _tail(state: EngineState, f: Front, odometry, fr=None, carry=None, *,
          mapping_input: bool, due: bool, imu: bool, cfg: LoamConfig):
    mapped = None
    if due:
        mapped = mapping_mod.finish(state.mapping, fr, carry.tf,
                                    f.imu_rpy if imu else None, cfg)
    return close(state, f, odometry, mapped, mapping_input, due)


def _stack(items, dim: int = 0):
    """Stack a list of equal NamedTuple trees leaf by leaf."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([it[i] for it in items], dim)
                             for i in range(len(first))))
    return torch.stack(items, dim)


def check_static_chunk(cfg: LoamConfig, k: int, cadence: Cadence) -> None:
    """Raise unless K sweeps from ``cadence`` make a static-cadence
    chunk: io_ratio >= 2, stack_frame_num == 1, the chunk on io_ratio
    boundaries."""
    io = cfg.odometry.io_ratio
    if io < 2 or cfg.mapping.stack_frame_num != 1:
        raise ValueError("static cadence needs io_ratio >= 2 and "
                         "stack_frame_num == 1")
    if k % io or cadence.sweep % io:
        raise ValueError(f"chunk (start {cadence.sweep}, length {k}) not "
                         f"aligned to io_ratio {io}")


def run_chunk(state: EngineState, raws: scan_mod.RawSweep, cfg: LoamConfig,
              cadence: Cadence = Cadence(),
              imu_windows: Optional[imu_ops.ImuWindow] = None,
              static_cadence: bool = True
              ) -> Tuple[EngineState, EngineOutputs]:
    """Process K sweeps (raws, and imu_windows if given, with a leading
    K axis) from the counters ``cadence``; returns outputs stacked along
    K. static_cadence=True: mapping on sweeps with index % io_ratio == 1
    and the static GN schedules; the chunk must start on an io_ratio
    boundary, with io_ratio >= 2 and stack_frame_num == 1. Otherwise a
    loop of ``step(mapping_mode="auto")`` with the dynamic schedules.
    This is the eager chunk, operation by operation: on the card
    ``Engine.run_chunk`` replays it as CUDA graphs (``models/graph.py``),
    and this function stays the plain reference they are held to."""
    io = cfg.odometry.io_ratio
    k = raws.xyz.shape[0]
    if static_cadence:
        check_static_chunk(cfg, k, cadence)
    outs = []
    for i in range(k):
        raw = scan_mod.RawSweep(xyz=raws.xyz[i], mask=raws.mask[i])
        win = None if imu_windows is None else imu_ops.window_at(imu_windows, i)
        if static_cadence:
            mode = "on" if i % io == 1 else "off"
            state, o = step(state, raw, cfg, mode, cadence, win,
                            static_schedule=True)
        else:
            state, o = step(state, raw, cfg, "auto", cadence, win)
        cadence = cadence.advance(cfg)
        outs.append(o)
    return state, _stack(outs)


def static_group(cfg: LoamConfig, cadence: Cadence):
    """One group of io_ratio sweeps of the static chunk from ``cadence``,
    eager: ``fn(state, xyz, mask, imu_windows) -> (state, outputs)``
    (what ``Engine.graphs`` captures)."""
    def group(state, xyz, mask, wins):
        return run_chunk(state, scan_mod.RawSweep(xyz, mask), cfg, cadence,
                         wins, static_cadence=True)
    return group


def registered_cloud(state: EngineState, raw: scan_mod.RawSweep,
                     cfg: LoamConfig,
                     imu_window: Optional[imu_ops.ImuWindow] = None) -> PointSet:
    """The full-resolution sweep in the map frame: ingested (IMU-deskewed
    with the window the sweep was processed with), deskewed to the sweep
    end with the odometry motion and the IMU start / end terms, then
    moved by the mapped pose. Call after the sweep's step."""
    _, full = scan_mod.ingest_sweep(raw, cfg.lidar, cfg.registration, imu_window)
    if imu_window is not None:
        imu0 = imu_ops.sweep_state(imu_window, cfg.registration.scan_period)
    else:
        imu0 = odometry_mod.ImuSweepState.zero(raw.xyz.device)
    xyz = lm.transform_to_end(full.xyz, full.rel, state.odometry.transform,
                              imu0.start_rpy, imu0.end_rpy,
                              imu0.shift_from_start)
    xyz = lm.pose_transform_points(state.mapping.transform_aft, xyz)
    return PointSet(xyz=xyz, rel=torch.zeros_like(full.rel), ring=full.ring,
                    mask=full.mask)


class Engine:
    """A run on one device: the engine state and the host's copy of its
    cadence counters. ``device`` is the card unless the caller asks for
    the CPU. On the card the per-sweep step (``step``, and the dynamic
    cadence of ``run_chunk``) replays the per-sweep graphs
    (``step_graphed`` through ``sweep_graphs``, shared by every engine of
    this configuration on the card), as the JAX driver runs its jitted
    step, and the static chunk runs as CUDA graphs of one group of
    io_ratio sweeps (``graphs``, a ``models/graph.py`` ``ChunkGraphs``
    captured on first use per key), as the JAX driver runs its jitted
    chunk; on the CPU both run eagerly. ``state`` is the caller's to
    read and to replace between calls: each graphed call copies it in."""

    def __init__(self, cfg: LoamConfig, device="cuda",
                 state: EngineState | None = None):
        # Full float32 matrix products on the card (the GN normal
        # equations); TF32 would keep ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = require_device(device)
        self.graphs = graph_mod.ChunkGraphs(
            cfg, functools.partial(static_group, cfg))
        if state is None:
            self.state, self.cadence = EngineState.create(cfg, self.device), Cadence()
        else:
            self.load_state(state)

    @property
    def sweep(self) -> int:
        return self.cadence.sweep

    @property
    def sweep_graphs(self) -> graph_mod.SweepGraphs:
        """The per-sweep graphs of this configuration on this card."""
        return graph_mod.sweep_graphs(self.cfg, self.device)

    def load_state(self, state: EngineState) -> None:
        """Adopt a state (a loaded checkpoint, say) and its counters."""
        self.state = state
        self.cadence = Cadence.of(state)

    def _raws(self, xyz: Tensor, mask: Tensor) -> scan_mod.RawSweep:
        return scan_mod.RawSweep(xyz=xyz.to(self.device, torch.float32),
                                 mask=mask.to(self.device, torch.bool))

    def _per_sweep(self, raw: scan_mod.RawSweep,
                   imu_window: Optional[imu_ops.ImuWindow]):
        """(state, outputs) of one sweep from ``self.state``: the graphs
        on the card, the eager step on the CPU."""
        if self.device.type == "cuda":
            return step_graphed(self.sweep_graphs, self.state, raw, self.cfg,
                                self.cadence, imu_window)
        return step(self.state, raw, self.cfg, "auto", self.cadence, imu_window)

    def step(self, xyz: Tensor, mask: Tensor,
             imu_window: Optional[imu_ops.ImuWindow] = None) -> EngineOutputs:
        """One sweep on the per-sweep path: the cadence gate and the
        dynamic GN schedules."""
        self.state, outs = self._per_sweep(self._raws(xyz, mask), imu_window)
        self.cadence = self.cadence.advance(self.cfg)
        return outs

    def run_chunk(self, xyz: Tensor, mask: Tensor,
                  imu_windows: Optional[imu_ops.ImuWindow] = None,
                  static_cadence: bool = True) -> EngineOutputs:
        """Process a (K, N, 3) / (K, N) chunk of raw sweeps. The static
        cadence runs through the chunk's CUDA graphs on the card; the
        dynamic one is K sweeps of ``step``."""
        raws = self._raws(xyz, mask)
        k = xyz.shape[0]
        if not static_cadence:
            return _stack([self.step(raws.xyz[i], raws.mask[i],
                                     None if imu_windows is None
                                     else imu_ops.window_at(imu_windows, i))
                           for i in range(k)])
        if self.device.type == "cuda":
            check_static_chunk(self.cfg, k, self.cadence)
            self.state, outs = self.graphs(self.state, raws.xyz, raws.mask,
                                           imu_windows, self.cadence)
        else:
            self.state, outs = run_chunk(self.state, raws, self.cfg,
                                         self.cadence, imu_windows)
        for _ in range(k):
            self.cadence = self.cadence.advance(self.cfg)
        return outs

    def registered_cloud(self, xyz: Tensor, mask: Tensor,
                         imu_window: Optional[imu_ops.ImuWindow] = None
                         ) -> PointSet:
        return registered_cloud(self.state, self._raws(xyz, mask), self.cfg,
                                imu_window)
