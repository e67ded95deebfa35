"""Host-side driver: feeds sweeps to the engine on the card.

Counterpart of ``loam_velodyne_tpu/io/driver.py``: the startup delay
(``system_delay`` dropped sweeps), padding to the fixed sweep capacity,
the optional IMU tracker, one readback of the (29,) packed output row
per sweep, telemetry into ``Metrics``, the surround map on its cadence
(built on the device, read to the host only when asked for), the
archive compaction at 3/4 of the pool, checkpoints (explicit and every
N sweeps) with resume, the chunked throughput mode, the pipelined live
loop, the rosbag replay (``run_bag``) and the TUM export. It drives
``models/engine.py::Engine`` on the per-sweep path
(``mapping_mode="auto"``, the dynamic GN schedules).

The live loop pipelines one sweep deep: it dispatches sweep N, copies
its packed row into pinned host memory behind a CUDA event, stages
sweep N+1 (pad, host-to-device copy, IMU window) and only then waits
for sweep N-1's row. That wait is its one synchronization per sweep
(the dynamic GN reads its stop flags inside the step).
"""

from __future__ import annotations

import os
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.io.rosbag import read_messages
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models.engine import Engine, EngineOutputs, EngineState
from loam_velodyne_torch.ops.imu import ImuWindow
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.utils import math as lm
from loam_velodyne_torch.utils.checkpoint import load_pytree, save_pytree
from loam_velodyne_torch.utils.profiling import Metrics


class LoamDriver:
    """Owns the engine and the host<->device boundary."""

    # Telemetry counter names in EngineOutputs.packed[20:28] order.
    _PACKED_COUNTERS = (
        "ingest_dropped", "feature_dropped",
        "cube_corner_dropped", "cube_surf_dropped",
        "stack_corner_dropped", "stack_surf_dropped",
        "active_cube_deficit", "archive_reinstated")

    def __init__(self, cfg: Optional[LoamConfig] = None, device="cuda",
                 sweep_capacity: Optional[int] = None,
                 system_delay: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0):
        self.cfg = cfg or LoamConfig.preset("VLP-16")
        self.engine = Engine(self.cfg, device)
        self.device = self.engine.device
        # The sensor's full-cloud capacity unless told otherwise.
        self.sweep_capacity = (self.cfg.capacities.full_cloud
                               if sweep_capacity is None else sweep_capacity)
        self.system_delay = (self.cfg.registration.system_delay
                             if system_delay is None else system_delay)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self._delay_left = self.system_delay
        self._stepped = 0              # sweeps this driver has stepped
        self.resumed_sweeps = 0
        self.imu_tracker: Optional[ImuTracker] = None
        self.trajectory: List[np.ndarray] = []        # fused poses (6,)
        self.odom_trajectory: List[np.ndarray] = []
        self.mapped_trajectory: List[np.ndarray] = []
        self.mapping_ran: List[bool] = []              # per sweep
        self.step_times: List[float] = []
        self.live_events: List[dict] = []
        self.metrics = Metrics()
        # Surround map: built on the device on its cadence frames, read
        # to the host when ``surround_map`` is accessed.
        self._surround_device = None
        self._surround_np = None
        self.surround_count = 0
        # Archive compaction: checked every _compact_check_every sweeps
        # from the cursor in the packed row, run past 3/4 of the pool.
        self._compact_check_every = 64
        self._sweeps_since_compact_check = 0
        self._archive_cnt_hint: Optional[int] = None
        self._pinned: List[torch.Tensor] = []
        self._slot = 0

    # ------------------------------------------------------------------
    # Feeding
    # ------------------------------------------------------------------
    def pad_sweep(self, pts: np.ndarray) -> RawSweep:
        """A sweep (N, 3) padded to the sweep capacity, on the device.
        The copies do not wait for the device's queue."""
        n = min(len(pts), self.sweep_capacity)
        xyz = np.zeros((self.sweep_capacity, 3), np.float32)
        xyz[:n] = pts[:n]
        mask = np.zeros((self.sweep_capacity,), bool)
        mask[:n] = True
        return RawSweep(xyz=torch.from_numpy(xyz).to(self.device, non_blocking=True),
                        mask=torch.from_numpy(mask).to(self.device,
                                                       non_blocking=True))

    def _window(self, stamp: Optional[float]) -> Optional[ImuWindow]:
        if self.imu_tracker is None or stamp is None:
            return None
        return self.imu_tracker.window_for_sweep(stamp, device=self.device)

    def process_sweep(self, pts: np.ndarray, stamp: Optional[float] = None
                      ) -> Optional[EngineOutputs]:
        """Feed one raw sweep (N, 3) in the sensor frame. Returns its
        outputs on the host (``EngineOutputs.unpack``), or None while the
        startup delay drains. With an IMU tracker and a stamp the sweep
        is IMU-deskewed."""
        if self._delay_left > 0:
            self._delay_left -= 1
            return None
        raw = self.pad_sweep(pts)
        t0 = time.perf_counter()
        outs = self.engine.step(raw.xyz, raw.mask, self._window(stamp))
        self._stepped += 1
        p = outs.packed.cpu().numpy()            # the one readback
        dt = time.perf_counter() - t0
        self.step_times.append(dt)
        self.metrics.record("step", dt)
        self._consume_packed(p)
        self._maybe_checkpoint()
        return EngineOutputs.unpack(p)

    def _consume_packed(self, p: np.ndarray) -> None:
        """Record trajectories, telemetry and cadence events from packed
        rows ((29,) or (K, 29); layout in models/engine.py)."""
        p = np.atleast_2d(np.asarray(p))
        for row in p:
            self.odom_trajectory.append(row[0:6].copy())
            self.mapped_trajectory.append(row[6:12].copy())
            self.trajectory.append(row[12:18].copy())
            self.mapping_ran.append(bool(row[18]))
        for i, name in enumerate(self._PACKED_COUNTERS):
            self.metrics.count(name, int(np.sum(p[:, 20 + i])))
        self._archive_cnt_hint = int(p[-1, 28])
        self._sweeps_since_compact_check += len(p)
        if self._sweeps_since_compact_check >= self._compact_check_every:
            self._sweeps_since_compact_check = 0
            self._maybe_compact_archive()
        if np.any(p[:, 19] > 0):      # surround_due on any sweep
            self._build_surround()

    def _maybe_compact_archive(self) -> None:
        """Dedup-compact the archive pool once it passes 3/4 full
        (``mapping.compact_archive``); the cursor comes from the packed
        rows."""
        mcfg = self.cfg.mapping
        ms = self.engine.state.mapping
        cnt = self._archive_cnt_hint
        if cnt is None:
            cnt = int(ms.archive_cnt)
        if cnt <= 3 * mcfg.archive_capacity // 4:
            return
        xyz, kind, valid, cnt = mapping_mod.compact_archive(
            (ms.archive_xyz, ms.archive_kind, ms.archive_valid, ms.archive_cnt),
            mcfg)
        self.engine.state = self.engine.state._replace(mapping=ms._replace(
            archive_xyz=xyz, archive_kind=kind, archive_valid=valid,
            archive_cnt=cnt))
        self._archive_cnt_hint = int(cnt)
        self.metrics.count("archive_compactions")

    @property
    def surround_map(self):
        """Latest downsized surround cloud as (xyz (N, 3), mask (N,))
        numpy, or None before the first publish frame; read from the
        device here, off the per-sweep path."""
        if self._surround_np is None and self._surround_device is not None:
            ps = self._surround_device
            self._surround_np = (ps.xyz.cpu().numpy(), ps.mask.cpu().numpy())
        return self._surround_np

    def _build_surround(self) -> None:
        """Dispatch the surround-map build from the current state; its
        dispatch time is a metric of its own."""
        t0 = time.perf_counter()
        ps = mapping_mod.surround_map(self.engine.state.mapping, self.cfg)
        self.metrics.record("surround_dispatch", time.perf_counter() - t0)
        self._surround_device = ps
        self._surround_np = None
        self.surround_count += 1
        self.metrics.count("surround_maps")

    def _maybe_checkpoint(self) -> bool:
        """Save the auto-checkpoint every ``checkpoint_every`` sweeps
        stepped; returns whether it did."""
        if not (self.checkpoint_path and self.checkpoint_every
                and self._stepped % self.checkpoint_every == 0):
            return False
        self.save_checkpoint(self.checkpoint_path)
        return True

    def resume(self) -> bool:
        """Load the auto-checkpoint if one exists; returns True if the
        engine state was restored. ``resumed_sweeps`` then holds the
        number of sweeps the restored state had processed."""
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            self.load_checkpoint(self.checkpoint_path)
            self.resumed_sweeps = self.engine.cadence.sweep
            return True
        return False

    def run(self, sweeps: Iterable[np.ndarray]) -> np.ndarray:
        """Process a full sequence; returns fused positions (K, 3)."""
        for pts in sweeps:
            self.process_sweep(pts)
        return self.positions()

    def _readback(self, packed: torch.Tensor):
        """Start the packed row's copy to the host: into one of two
        pinned buffers behind a CUDA event on the card."""
        if self.device.type != "cuda":
            return packed, None
        if not self._pinned:
            self._pinned = [torch.empty(packed.shape, dtype=packed.dtype,
                                        pin_memory=True) for _ in range(2)]
        buf = self._pinned[self._slot]
        self._slot ^= 1
        buf.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    @staticmethod
    def _drain(pending) -> np.ndarray:
        buf, ev = pending
        if ev is not None:
            ev.synchronize()
        return buf.numpy().copy()

    def run_live(self, sweeps: Iterable[np.ndarray],
                 stamps: Optional[Iterable[float]] = None) -> List[float]:
        """Latency-oriented live loop, pipelined one sweep deep: while
        sweep N runs on the device, the host stages sweep N+1 and drains
        sweep N-1's packed row, so neither the input copy nor the output
        readback sits on the per-sweep critical path. A pose reaches the
        host one iteration later. stamps: each sweep's start time, for
        the IMU tracker. Returns per-sweep wall latencies in seconds;
        ``live_events`` splits each into dispatch (the step), stage (the
        next sweep's pad, copy and IMU window) and consume (the drain
        and the cadence work it triggers: surround, compaction, the
        auto-checkpoint)."""
        it = iter(sweeps)
        st = None if stamps is None else iter(stamps)

        def stage():
            pts = next(it)
            return self.pad_sweep(pts), self._window(None if st is None else next(st))

        try:
            cur = stage()
        except StopIteration:
            return []
        lat: List[float] = []
        self.live_events = []
        done = False
        pending = None
        while not done:
            t0 = time.perf_counter()
            outs = self.engine.step(cur[0].xyz, cur[0].mask, cur[1])
            self._stepped += 1
            this = self._readback(outs.packed)
            t_disp = time.perf_counter()
            try:
                cur = stage()
            except StopIteration:
                done = True
            t_stage = time.perf_counter()
            counters = self.metrics.counters
            sur0 = counters.get("surround_maps", 0)
            cmp0 = counters.get("archive_compactions", 0)
            if pending is not None:
                self._consume_packed(self._drain(pending))
            ckpt = self._maybe_checkpoint()
            t_cons = time.perf_counter()
            pending = this
            dt = t_cons - t0
            lat.append(dt)
            self.live_events.append({
                "dispatch_ms": 1e3 * (t_disp - t0),
                "stage_ms": 1e3 * (t_stage - t_disp),
                "consume_ms": 1e3 * (t_cons - t_stage),
                "surround": counters.get("surround_maps", 0) - sur0,
                "compact": counters.get("archive_compactions", 0) - cmp0,
                "checkpoint": int(ckpt),
            })
            self.step_times.append(dt)
            self.metrics.record("step", dt)
        self._consume_packed(self._drain(pending))
        return lat

    def run_chunked(self, sweeps: List[np.ndarray], chunk: int = 8,
                    stamps: Optional[List[float]] = None) -> np.ndarray:
        """Throughput mode: K sweeps per engine call, one readback of
        the (K, 29) packed rows. The startup delay must be drained
        first. stamps: per-sweep start times; with an IMU tracker the
        sweeps are IMU-deskewed (windows stacked on K)."""
        if self._delay_left > 0:
            raise RuntimeError("drain system_delay before run_chunked")
        use_imu = self.imu_tracker is not None and stamps is not None
        for start in range(0, len(sweeps), chunk):
            batch = sweeps[start:start + chunk]
            k = len(batch)
            xyz = np.zeros((k, self.sweep_capacity, 3), np.float32)
            mask = np.zeros((k, self.sweep_capacity), bool)
            for i, pts in enumerate(batch):
                n = min(len(pts), self.sweep_capacity)
                xyz[i, :n] = pts[:n]
                mask[i, :n] = True
            wins = None
            if use_imu:
                rows = [self._window(s) for s in stamps[start:start + k]]
                wins = ImuWindow(*(torch.stack(a) for a in zip(*rows)))
            t0 = time.perf_counter()
            outs = self.engine.run_chunk(torch.from_numpy(xyz),
                                         torch.from_numpy(mask), wins,
                                         static_cadence=False)
            self._stepped += k
            packed = outs.packed.cpu().numpy()       # one (K, 29) readback
            self.step_times.append((time.perf_counter() - t0) / k)
            self._consume_packed(packed)
        return self.positions()

    def positions(self) -> np.ndarray:
        if not self.trajectory:
            return np.zeros((0, 3))
        return np.stack(self.trajectory)[:, 3:]

    def run_bag(self, path: str, cloud_topic: str = "/velodyne_points",
                imu_topic: str = "/imu/data", native: bool = True
                ) -> np.ndarray:
        """Replay a rosbag end to end in message order: IMU messages feed
        a new IMU tracker, each cloud is a sweep stamped with its message
        time (the equivalent of the reference's 4-node launch over
        ``rosbag play``). After ``resume()`` the clouds the restored
        state already consumed (the startup delay and the processed
        sweeps) are skipped; the IMU messages before them still warm the
        tracker. Returns the fused positions (K, 3)."""
        self.imu_tracker = ImuTracker(self.cfg.registration.imu_history_size)
        skip = 0
        if self.resumed_sweeps and not self.trajectory:
            skip = self._delay_left + self.resumed_sweeps
            self._delay_left = 0
        for kind, stamp, payload in read_messages(
                path, cloud_topic=cloud_topic, imu_topic=imu_topic,
                native=native):
            if kind == "imu":
                self.imu_tracker.push_raw(stamp, payload[:4], payload[4:7])
            elif skip > 0:
                skip -= 1
            else:
                self.process_sweep(payload, stamp)
        return self.positions()

    def registered_cloud(self, pts: np.ndarray, stamp: Optional[float] = None):
        """The sweep just processed, at full resolution, in the map frame
        (deskewed with the same IMU window when a tracker and a stamp
        are given); returns (xyz (N, 3), mask (N,)) numpy."""
        raw = self.pad_sweep(pts)
        ps = self.engine.registered_cloud(raw.xyz, raw.mask, self._window(stamp))
        return ps.xyz.cpu().numpy(), ps.mask.cpu().numpy()

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        save_pytree(path, self.engine.state)

    def load_checkpoint(self, path: str) -> None:
        template = EngineState.create(self.cfg, "meta")
        self.engine.load_state(load_pytree(path, template, self.device))

    # ------------------------------------------------------------------
    # Exports
    # ------------------------------------------------------------------
    def export_tum(self, path: str, dt: float | None = None) -> None:
        """Trajectory in TUM format (timestamp tx ty tz qx qy qz qw),
        LOAM camera frame."""
        dt = dt or self.cfg.registration.scan_period
        with open(path, "w") as f:
            for k, pose in enumerate(self.trajectory):
                r = lm.pose_rot_mat(torch.from_numpy(
                    np.asarray(pose, np.float32))).numpy()
                q = _rot_to_quat(r)
                t = pose[3:]
                f.write(f"{k * dt:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (r[k, j] - r[j, k]) / s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])
