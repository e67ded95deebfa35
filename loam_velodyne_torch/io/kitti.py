"""KITTI odometry dataset reading (HDL-64E benchmark config #4 in
BASELINE.md).

The port's copy of ``loam_velodyne_tpu/io/kitti.py``.

KITTI velodyne scans are flat little-endian float32 files of
(x, y, z, reflectance) in the sensor frame (x fwd, y left, z up) —
already the frame our ingest expects. Ground-truth poses are 3x4
row-major world_T_cam matrices per line; for trajectory evaluation we
convert them into LOAM-camera-frame positions.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI scan -> (N, 3) float32 (reflectance dropped)."""
    raw = np.fromfile(path, np.float32)
    if len(raw) % 4:
        raise ValueError(f"{path}: length {len(raw)} not a multiple of 4")
    return raw.reshape(-1, 4)[:, :3].copy()


def read_sequence(scan_dir: str, limit: int | None = None
                  ) -> Tuple[List[np.ndarray], List[float]]:
    """Read a KITTI sequence directory of %06d.bin scans."""
    names = sorted(f for f in os.listdir(scan_dir) if f.endswith(".bin"))
    if limit is not None:
        names = names[:limit]
    sweeps = [read_velodyne_bin(os.path.join(scan_dir, f)) for f in names]
    times = [0.1 * i for i in range(len(sweeps))]
    return sweeps, times


def read_poses(path: str) -> np.ndarray:
    """KITTI ground-truth poses file -> (K, 3, 4) float64 matrices."""
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    return rows.reshape(-1, 3, 4)


def poses_to_loam_positions(poses: np.ndarray) -> np.ndarray:
    """Ground-truth positions in the LOAM camera frame.

    KITTI poses are cam0-frame (x right, y down, z forward); LOAM's
    camera frame is x left, y up, z forward — a sign flip on x and y.
    """
    t = poses[:, :, 3]
    return np.stack([-t[:, 0], -t[:, 1], t[:, 2]], axis=1)


def write_velodyne_bin(path: str, xyz: np.ndarray,
                       reflectance: np.ndarray | None = None) -> None:
    """Fixture/export writer for KITTI-format scans."""
    xyz = np.asarray(xyz, np.float32)
    r = (np.zeros((len(xyz), 1), np.float32) if reflectance is None
         else np.asarray(reflectance, np.float32).reshape(-1, 1))
    np.hstack([xyz, r]).astype(np.float32).tofile(path)
