"""The comparison that decides ``correct``.

The reference is ``oracle.py``: the C++ LOAM pipeline transliterated into
NumPy, apart from the port. It takes nothing that the program made: it is
handed the same points the timed path was handed, starts from its own
fresh state and runs a short stretch, so that the two designs (the port's
fixed capacities and vectorised searches, the C++'s unbounded maps) do
not drift apart over a long drive. After the window, the entry hands over
samples of the window's work drawn from the seed, of two kinds:

- ``start``: a lane's first sweeps from a fresh state (a bag or a drive
  starting), compared sweep by sweep on every pose a user sees:
  odometry, mapped and fused; this covers ingest, features, odometry,
  mapping with its first map and the fusion;
- ``odometry``: three consecutive sweeps of a lane in the middle of its
  bag or drive; the reference starts fresh at the first, and the pose
  change from the second to the third (the odometry step, which depends
  on the last sweep and not on the map) is compared.

Five numbers are taken over all samples:

- ``start_rot_gap`` / ``start_pos_gap``: over the ``start`` samples, the
  largest angle (rad) between a program's rotation and the reference's,
  and the largest distance (m) between their positions;
- ``step_rot_gap`` / ``step_pos_gap``: the same over the ``odometry``
  samples' pose changes, which span one sweep and so read less;
- ``shed_gap``: the largest difference, over the sweeps handed in, of the
  rows shed at ingest and in the features (the program's loss counters
  against what the configuration's capacities shed of the reference's
  rings and feature clouds).

Each must be at most its limit (``workloads/<cell>.json``). The map's own
loss counters and the archive cursor have no counterpart in the C++ (its
map is unbounded) and are not compared.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List

import numpy as np

from loam_bench import oracle

NUMBERS = ("start_rot_gap", "start_pos_gap", "step_rot_gap",
           "step_pos_gap", "shed_gap")
POSES = (slice(0, 6), slice(6, 12), slice(12, 18))    # odom, mapped, fused
INGEST_SHED, FEATURE_SHED = 20, 21                    # packed row columns


@dataclasses.dataclass
class Sample:
    """A stretch of one lane's work: the points handed in (host (N_i, 3)
    arrays, filled in by the entry after the window) and the program's
    packed rows for them ((n, 29))."""

    label: str
    kind: str                   # "start" or "odometry"
    lane: int
    first: int                  # the stretch's first sweep of the lane's drive
    rows: np.ndarray
    sweeps: list = dataclasses.field(default_factory=list)


def matrix(pose: np.ndarray) -> np.ndarray:
    """A LOAM pose (rx, ry, rz, tx, ty, tz) as a 4x4 transform."""
    t = np.eye(4)
    t[:3, :3] = oracle.rot_zxy(*pose[:3])
    t[:3, 3] = pose[3:6]
    return t


def gaps(a: np.ndarray, b: np.ndarray) -> tuple:
    """(angle in rad, distance in m) between two 4x4 transforms."""
    fro = np.linalg.norm(a[:3, :3] - b[:3, :3])
    angle = 2.0 * math.asin(min(1.0, fro / (2.0 * math.sqrt(2.0))))
    return angle, float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


def step_of(poses: np.ndarray, i: int) -> np.ndarray:
    """The transform from sweep i - 1's pose to sweep i's."""
    return np.linalg.inv(matrix(poses[i - 1])) @ matrix(poses[i])


def compare(sample: Sample, ref: dict) -> dict:
    """The numbers of one sample against the reference's run (those of
    the other kind of sample read 0)."""
    rows = np.asarray(sample.rows, np.float64)
    rot = pos = 0.0
    if not np.isfinite(rows[:, :18]).all():
        rot = pos = math.inf
    elif sample.kind == "start":
        for k in range(len(rows)):
            for sl in POSES:
                r, p = gaps(matrix(rows[k, sl]), matrix(ref["poses"][k, sl]))
                rot, pos = max(rot, r), max(pos, p)
    else:
        r, p = gaps(step_of(rows[:, POSES[0]], len(rows) - 1),
                    step_of(ref["poses"][:, POSES[0]], len(rows) - 1))
        rot, pos = r, p
    program = rows[:, [INGEST_SHED, FEATURE_SHED]].astype(np.int64)
    shed = int(np.abs(program - ref["shed"]).max()) if len(rows) else 0
    kind = "start" if sample.kind == "start" else "step"
    out = {k: 0.0 for k in NUMBERS}
    out.update({f"{kind}_rot_gap": rot, f"{kind}_pos_gap": pos,
                "shed_gap": float(shed)})
    return out


def references(samples: List[Sample], loam: dict, workers: int) -> list:
    """The reference over every sample, in ``workers`` processes (one
    thread each) where more than one is asked for."""
    if workers <= 1:
        return [oracle.follow(loam, s.sweeps) for s in samples]
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(samples)),
                             mp_context=ctx) as pool:
        futures = [pool.submit(oracle.follow, loam, s.sweeps)
                   for s in samples]
        return [f.result() for f in futures]


def judge(samples: List[Sample], config: dict, limits: dict,
          workers: int = 1) -> dict:
    """The numbers (their largest over the samples), each sample's
    numbers, and whether every number is within its limit."""
    worst = {k: 0.0 for k in NUMBERS}
    each = []
    refs = references(samples, config["loam"], workers) if samples else []
    for s, ref in zip(samples, refs):
        nums = compare(s, ref)
        each.append((s.label, nums))
        for k in NUMBERS:
            worst[k] = max(worst[k], nums[k])
    # A run is judged on both kinds of sample, or is not correct.
    missing = {"start", "odometry"} - {s.kind for s in samples}
    failed = len(missing) + sum(
        1 for _, nums in each if any(nums[k] > limits[k] for k in NUMBERS))
    return {"numbers": worst, "samples": each, "failed": failed,
            "missing": sorted(missing), "correct": failed == 0}
