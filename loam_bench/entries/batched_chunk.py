"""``batched_chunk``: B aligned lanes through
``parallel/replay.py::make_batched_chunk`` (the static cadence), a chunk
of K sweeps of every lane a call, each bag from fresh lanes. Its
``odometry`` samples lie inside a chunk; its ``boundary`` samples span
the hand-over from one call to the next (the last sweeps of a chunk and
the first of the next)."""

from __future__ import annotations

import numpy as np

from loam_bench import traffic as traffic_mod
from loam_bench.entry import (ODOMETRY_SPAN, Entry, clone, lane_sweeps,
                              pick_lanes)
from loam_bench.window import StepResult
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay


class BatchedChunk(Entry):
    def setup(self) -> None:
        t = self.traffic
        self.k = int(t["chunk"])
        if self.k < ODOMETRY_SPAN:
            raise ValueError(f"chunks of {self.k} sweeps hold no "
                             f"{ODOMETRY_SPAN}-sweep odometry sample")
        self.xyz, self.mask, _ = traffic_mod.drives_on_card(
            t, self.sensor, self.seed, self.device)
        self.fn = replay.make_batched_chunk(self.cfg)
        self.bags = traffic_mod.bags(t)
        self._new_bag()
        for _ in range(int(t["warm_calls"])):
            self.step()

    def _new_bag(self) -> None:
        self.start, self.length = next(self.bags)
        if self.length % self.k:
            raise ValueError(f"a bag of {self.length} sweeps is not whole "
                             f"chunks of {self.k}")
        self.pos = 0
        self.states = replay.create_states(self.cfg, self.lanes, self.device)
        self.cadence = replay.Cadence()
        self.lane_tracks = [{"lane": b, "start": self.start, "rows": []}
                            for b in range(self.lanes)]
        self.tracks += self.lane_tracks
        self.last_rows = None             # the last chunk's final rows
        for b in pick_lanes(self.rng, self.lanes, self.n_starts):
            self.begin_start(b, self.start)

    def step(self) -> StepResult:
        if self.pos == self.length:
            self._new_bag()
        s = self.start + self.pos
        xyz, mask = self.xyz[:, s:s + self.k], self.mask[:, s:s + self.k]
        if not self.in_window:
            self.saved = (clone(self.states), self.cadence, s)
        self.states, outs = self.fn(self.states, RawSweep(xyz, mask),
                                    self.cadence)
        for _ in range(self.k):
            self.cadence = self.cadence.advance(self.cfg)
        host = outs.packed.cpu().numpy()
        self._account(host, self.lane_tracks)
        self.feed_starts({b: host[b] for b in range(self.lanes)})
        for b in range(self.lanes):
            j = int(self.rng.integers(self.k - ODOMETRY_SPAN + 1))
            self.offer_odometry(b, s + j, host[b, j:j + ODOMETRY_SPAN])
            if self.last_rows is not None:
                # A stretch across the hand-over from the last call.
                j = int(self.rng.integers(1, ODOMETRY_SPAN))
                self.offer_odometry(b, s - j, np.concatenate(
                    [self.last_rows[b, self.k - j:], host[b, :ODOMETRY_SPAN - j]]),
                    boundary=True)
        self.last_rows = host
        self.pos += self.k
        return StepResult(steps=self.k, lane_sweeps=self.lanes * self.k)

    def sweeps_of(self, lane: int, first: int, n: int) -> list:
        return lane_sweeps(self.xyz, self.mask, lane, first, n)

    def eager_replay(self) -> None:
        """Two sweeps of every lane through the eager batched chunk, from
        a state the window started a chunk from."""
        states, cadence, s = self.saved
        eager = replay.make_eager_batched_chunk(self.cfg)
        io = self.cfg.odometry.io_ratio
        eager(states, RawSweep(self.xyz[:, s:s + io], self.mask[:, s:s + io]),
              cadence)

    def release(self) -> None:
        self.states = self.saved = None


ENTRY = BatchedChunk
