"""What the entries share (``entries/<name>.py``, one a way of driving the
system, named by a traffic file's ``"entry"``).

An entry hands its work over in a closed loop (the next call when the
last one's poses are on the host), sums the loss counters of every sweep
in the window, keeps each lane's fused positions for its ATE, and keeps
the samples that ``check.py`` compares, drawn from the seed: a lane's
first sweeps from a fresh state (``start``) and three consecutive sweeps
of a lane in the middle of its run (``odometry``). It records only the
program's host rows and where the sweeps lie during the window; the
sweeps are copied to the host after it (``sample_list``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from loam_bench import traffic as traffic_mod
from loam_bench.check import Sample
from loam_bench.sim import ate_rmse
from loam_bench.window import Reservoir

# Packed row columns (the port's ``EngineOutputs.packed``): the fused
# position, and the seven loss counters (ingest, feature, cube corner /
# surf, stack corner / surf, active-cube deficit).
FUSED_XYZ = slice(15, 18)
LOSS = slice(20, 27)
LOSS_NAMES = ("ingest_dropped", "feature_dropped", "cube_corner_dropped",
              "cube_surf_dropped", "stack_corner_dropped",
              "stack_surf_dropped", "active_cube_deficit")
ODOMETRY_SPAN = 3          # sweeps in an ``odometry`` sample


def clone(tree):
    """A copy of a tree of NamedTuples of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone(x) for x in tree))


class Entry:
    """The traffic's sweeps, the loss counters, the lanes' tracks for ATE
    and the samples for the check."""

    def __init__(self, cell, seed: int, device):
        from loam_velodyne_torch.config import LoamConfig
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.traffic = cell.traffic
        self.sensor = traffic_mod.sensor(cell.config)
        self.cfg = LoamConfig.from_dict(cell.config["loam"])
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed % (1 << 64), 7]))
        self.lanes = int(self.traffic["lanes"])
        sampling = cell.check["sample"]
        self.start_sweeps = int(sampling["start_sweeps"])
        self.n_starts = int(sampling["starts"])
        self.odometry = Reservoir(int(sampling["odometry"]), self.rng)
        self.boundary = Reservoir(int(sampling.get("boundary", 0)), self.rng)
        self.samples: Dict[str, Sample] = {}      # odometry samples
        self.starts: Dict[str, List[Sample]] = {"setup": [], "window": []}
        self.pending: list = []       # (start sample still filling, where)
        self.in_window = False
        self.loss = np.zeros(len(LOSS_NAMES), np.int64)
        self.nonfinite = 0
        self.tracks: List[dict] = []       # one a bag run: lane, start, rows
        self.saved = None             # (state, inputs) for the eager replay

    def open_window(self) -> None:
        self.in_window = True
        self.loss[:] = 0
        self.nonfinite = 0

    def close_window(self) -> None:
        self.in_window = False

    def _account(self, rows: np.ndarray, lanes: List[dict]) -> None:
        """Host rows (B, K, 29): loss counters, non-finite poses, tracks."""
        if self.in_window:
            self.loss += rows[..., LOSS].reshape(-1, len(LOSS_NAMES)).astype(
                np.int64).sum(0)
            self.nonfinite += int((~np.isfinite(rows[..., :18])).any(-1).sum())
        for b, t in enumerate(lanes):
            t["rows"].append(rows[b, :, FUSED_XYZ])

    # -- samples ----------------------------------------------------------

    def _where(self) -> str:
        return "window" if self.in_window else "setup"

    def begin_start(self, lane: int, first: int) -> None:
        """A fresh start of ``lane`` at sweep ``first`` of its drive: its
        next ``start_sweeps`` rows make a ``start`` sample, while the
        window (else the set-up) has fewer than ``starts``."""
        where = self._where()
        if len(self.starts[where]) + sum(
                1 for s, w in self.pending if w == where) >= self.n_starts:
            return
        self.pending.append((Sample(
            f"start@{where} lane {lane} sweeps {first}-"
            f"{first + self.start_sweeps - 1}", "start", lane, first,
            np.zeros((0, 29), np.float32)), where))

    def end_run(self, lane: int) -> None:
        """``lane``'s bag or drive ended: a start sample of it that is
        still filling is dropped."""
        self.pending = [(s, w) for s, w in self.pending if s.lane != lane]

    def feed_starts(self, lane_rows: Dict[int, np.ndarray]) -> None:
        """Rows (k, 29) of some lanes, in sweep order, for the pending
        start samples."""
        still = []
        for s, where in self.pending:
            got = lane_rows.get(s.lane)
            if got is not None:
                need = self.start_sweeps - len(s.rows)
                s.rows = np.concatenate([s.rows, got[:need]])
            if len(s.rows) >= self.start_sweeps:
                self.starts[where].append(s)
            else:
                still.append((s, where))
        self.pending = still

    def offer_odometry(self, lane: int, first: int, rows: np.ndarray,
                       boundary: bool = False) -> None:
        """A window's stretch of ``ODOMETRY_SPAN`` consecutive sweeps of a
        lane from ``first`` (rows (3, 29)), kept if the seed's draw keeps
        it (``boundary``: a stretch across two calls, drawn apart)."""
        if not self.in_window:
            return
        name = "boundary" if boundary else "odometry"
        slot = (self.boundary if boundary else self.odometry).offer()
        if slot is not None:
            self.samples[f"{name}{slot}"] = Sample(
                f"{name}@window lane {lane} sweeps {first}-"
                f"{first + ODOMETRY_SPAN - 1}", "odometry", lane, first,
                np.array(rows, np.float32))

    def sweeps_of(self, lane: int, first: int, n: int) -> list:
        """The points handed in for sweeps ``first``.. of ``lane``'s drive,
        as host (N_i, 3) arrays."""
        raise NotImplementedError

    def sample_list(self) -> List[Sample]:
        """The samples, their sweeps copied to the host."""
        out = (self.starts["window"] or self.starts["setup"]) + [
            self.samples[k] for k in sorted(self.samples)]
        for s in out:
            s.sweeps = self.sweeps_of(s.lane, s.first, len(s.rows))
        return out

    def ate_lines(self) -> List[str]:
        out = []
        for t in self.tracks:
            if not t["rows"]:
                continue
            est = np.concatenate(t["rows"])
            if len(est) < 3:
                continue
            gt = traffic_mod.ground_truth(self.traffic, self.sensor, t["lane"],
                                          t["start"], len(est))
            out.append(f"ate lane {t['lane']} bag@{t['start']} "
                       f"sweeps {len(est)}: {ate_rmse(est, gt):.5f} m")
        return out

    def release(self) -> None:
        """Drop the program's live state (the samples stay)."""


def lane_sweeps(xyz: torch.Tensor, mask: torch.Tensor, lane: int,
                first: int, n: int) -> list:
    """Sweeps ``first``.. of a lane of padded drives on the card, as the
    host arrays of their valid points."""
    out = []
    for k in range(first, first + n):
        out.append(xyz[lane, k][mask[lane, k]].cpu().numpy())
    return out


def pick_lanes(rng, lanes: int, n: int) -> List[int]:
    """``n`` of the lanes, drawn from the seed."""
    return sorted(int(b) for b in rng.choice(lanes, size=min(n, lanes),
                                              replace=False))
