"""``live``: one vehicle through ``io/driver.py::LoamDriver.process_sweep``
with the driver's defaults (its startup delay, surround map and archive
compaction). The set-up warms the driver's graphs on a driver of its
own, then drains a fresh driver's startup delay, so the window opens at
that drive's first pose; a fresh driver takes over at each drive's end."""

from __future__ import annotations

import time

import numpy as np

from loam_bench import traffic as traffic_mod
from loam_bench.entry import ODOMETRY_SPAN, Entry, clone
from loam_bench.window import StepResult
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import mapping as mapping_mod


class Live(Entry):
    def setup(self) -> None:
        t = self.traffic
        self.sweeps = traffic_mod.drive_on_host(t, self.sensor, self.seed,
                                                self.device)
        self._new_drive()
        warm = int(t["warm_calls"])
        while self.processed < warm:
            self.step()
        # The driver's cadence work once before the window: a surround
        # build and an archive compaction of a copy of the state.
        self.drv._build_surround()
        ms = self.drv.engine.state.mapping
        mapping_mod.compact_archive(
            tuple(x.clone() for x in (ms.archive_xyz, ms.archive_kind,
                                      ms.archive_valid, ms.archive_cnt)),
            self.cfg.mapping)
        engine_mod.sync(self.device)
        self.saved = (clone(self.drv.engine.state), self.k)
        self._new_drive()
        while self.drv._delay_left > 0:
            self.step()

    def _new_drive(self) -> None:
        self.end_run(0)
        self.drv = LoamDriver(self.cfg, self.device)
        self.k = 0
        self.processed = 0
        self.recent = []                  # the last rows, for odometry samples
        self.track = {"lane": 0, "start": self.drv.system_delay, "rows": []}
        self.tracks.append(self.track)

    def step(self) -> StepResult:
        drv = self.drv
        pts = self.sweeps[self.k]
        if drv._delay_left == 0 and self.processed == 0:
            self.begin_start(0, self.k)
        t0 = time.perf_counter()
        out = drv.process_sweep(pts)
        dt = time.perf_counter() - t0
        self.k += 1
        if out is None:
            if self.k == len(self.sweeps):
                self._new_drive()
            return StepResult()
        row = np.asarray(out.packed)[None]
        self.processed += 1
        self._account(row[None], [self.track])
        self.feed_starts({0: row})
        self.recent = (self.recent + [row[0]])[-ODOMETRY_SPAN:]
        if len(self.recent) == ODOMETRY_SPAN:
            self.offer_odometry(0, self.k - ODOMETRY_SPAN,
                                np.stack(self.recent))
        host = dt - drv.step_times[-1]
        if self.k == len(self.sweeps):
            self._new_drive()
        return StepResult(steps=1, lane_sweeps=1, latencies=[dt], host=[host])

    def sweeps_of(self, lane: int, first: int, n: int) -> list:
        return self.sweeps[first:first + n]

    def eager_replay(self) -> None:
        """Two sweeps of the drive through the eager per-sweep step, from
        the state the set-up's driver reached."""
        state, k = self.saved
        for pts in self.sweeps[k:k + 2]:
            state, _ = engine_mod.step(state, self.drv.pad_sweep(pts),
                                       self.cfg, "auto",
                                       engine_mod.Cadence.of(state))

    def release(self) -> None:
        self.drv = self.saved = None


ENTRY = Live
