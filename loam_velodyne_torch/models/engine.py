"""The sweep-step engine: ingest -> features -> odometry -> mapping -> fusion.

Counterpart of ``loam_velodyne_tpu/models/engine.py``. ``step`` is a
plain function of (state, raw sweep); the cadence decisions that the
JAX package takes with ``lax.cond`` on device (odometry's first sweep,
mapping every io_ratio-th sweep) are pure functions of the sweep
counter, so here the host passes them in and nothing is read back from
the device. The device-side counters (``sweep``, ``mapping_inputs``)
are still carried, so the state matches the JAX layout.

``run_chunk`` is the static-cadence chunk (``static_cadence=True`` in
the JAX package) as a Python loop over ``step``; ``Engine`` holds the
device, the state and the host-side sweep counter for a replay.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import fusion as fusion_mod
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.ops import scan as scan_mod
from loam_velodyne_torch.ops.features import extract_features

Tensor = torch.Tensor


class EngineState(NamedTuple):
    odometry: odometry_mod.OdometryState
    mapping: mapping_mod.MappingState
    fusion: fusion_mod.FusionState
    sweep: Tensor            # () int32 processed-sweep counter
    mapping_inputs: Tensor   # () int32 bundles forwarded to mapping

    @staticmethod
    def create(cfg: LoamConfig, device) -> "EngineState":
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


def step(state: EngineState, raw: scan_mod.RawSweep, cfg: LoamConfig,
         mapping_mode: str, initialized: bool
         ) -> Tuple[EngineState, EngineOutputs]:
    """Process one sweep. ``initialized``: whether odometry has seen a
    sweep (False only on the first sweep of a sequence); ``mapping_mode``
    "on"/"off": whether this sweep is a mapping frame of the cadence
    ("on" requires an initialized odometry)."""
    if mapping_mode not in ("on", "off"):
        raise ValueError(f"mapping_mode must be 'on' or 'off', got {mapping_mode!r}")
    if mapping_mode == "on" and not initialized:
        raise ValueError("mapping cannot run on the first sweep")
    dev = raw.xyz.device
    grid, _ = scan_mod.ingest_sweep(raw, cfg.lidar, cfg.registration)
    feats = extract_features(grid, cfg.registration, cfg.capacities)
    ostate, oouts = odometry_mod.step(state.odometry, feats, cfg, initialized)

    io_ratio = cfg.odometry.io_ratio
    mapping_input = (((io_ratio < 2) | (torch.remainder(state.sweep, io_ratio) == 1))
                     & state.odometry.initialized)
    if mapping_mode == "on":
        mstate, mouts = mapping_mod.step(state.mapping, oouts.transform_sum,
                                         oouts.corner_cloud, oouts.surf_cloud,
                                         cfg)
        fstate = fusion_mod.update_mapping(state.fusion, mouts.transform_aft,
                                           mouts.transform_bef)
        surround_due, map_tel = mouts.surround_due, mouts.telemetry
    else:
        mstate, fstate = state.mapping, state.fusion
        surround_due = torch.zeros((), dtype=torch.bool, device=dev)
        map_tel = mapping_mod.MapTelemetry.zero(dev)
    mapping_due = torch.full((), mapping_mode == "on", dtype=torch.bool,
                             device=dev)
    fused = fusion_mod.fuse(fstate, oouts.transform_sum)

    new_state = EngineState(
        odometry=ostate, mapping=mstate, fusion=fstate,
        sweep=state.sweep + 1,
        mapping_inputs=state.mapping_inputs + mapping_input.to(torch.int32))
    tel = Telemetry(ingest_dropped=grid.dropped, feature_dropped=feats.dropped,
                    mapping=map_tel)
    outs = EngineOutputs(
        odom_pose=oouts.transform_sum, mapped_pose=fstate.transform_aft,
        fused_pose=fused, mapping_ran=mapping_due, surround_due=surround_due,
        telemetry=tel,
        packed=EngineOutputs.pack(oouts.transform_sum, fstate.transform_aft,
                                  fused, mapping_due, surround_due, tel,
                                  mstate.archive_cnt))
    return new_state, outs


def _stack(items):
    """Stack a list of equal NamedTuple trees leaf by leaf."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([it[i] for it in items])
                             for i in range(len(first))))
    return torch.stack(items)


def run_chunk(state: EngineState, raws: scan_mod.RawSweep, cfg: LoamConfig,
              start_sweep: int = 0) -> Tuple[EngineState, EngineOutputs]:
    """Process K sweeps (raws with a leading K axis) on the static
    cadence: mapping runs on sweeps with index % io_ratio == 1. The
    chunk must start on an io_ratio boundary (start_sweep, the index of
    its first sweep, counted from the sequence's first sweep). Returns
    outputs stacked along K."""
    io = cfg.odometry.io_ratio
    k = raws.xyz.shape[0]
    if io < 2 or cfg.mapping.stack_frame_num != 1:
        raise ValueError("static cadence needs io_ratio >= 2 and stack_frame_num == 1")
    if k % io or start_sweep % io:
        raise ValueError(f"chunk (start {start_sweep}, length {k}) not aligned "
                         f"to io_ratio {io}")
    outs = []
    for i in range(k):
        raw = scan_mod.RawSweep(xyz=raws.xyz[i], mask=raws.mask[i])
        mode = "on" if i % io == 1 else "off"
        state, o = step(state, raw, cfg, mapping_mode=mode,
                        initialized=start_sweep + i > 0)
        outs.append(o)
    return state, _stack(outs)


class Engine:
    """A replay on one device: the engine state and the host-side sweep
    counter that drives the cadence."""

    def __init__(self, cfg: LoamConfig, device, state: EngineState | None = None,
                 sweep: int = 0):
        # Full float32 matrix products on the card (the GN normal
        # equations); TF32 would keep ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = EngineState.create(cfg, self.device) if state is None else state
        self.sweep = sweep

    def run_chunk(self, xyz: Tensor, mask: Tensor) -> EngineOutputs:
        """Process a (K, N, 3) / (K, N) chunk of raw sweeps."""
        raws = scan_mod.RawSweep(xyz=xyz.to(self.device, torch.float32),
                                 mask=mask.to(self.device, torch.bool))
        self.state, outs = run_chunk(self.state, raws, self.cfg,
                                     start_sweep=self.sweep)
        self.sweep += xyz.shape[0]
        return outs
