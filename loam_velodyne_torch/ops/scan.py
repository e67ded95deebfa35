"""Sweep ingest: raw lidar points -> per-ring grid.

Counterpart of ``loam_velodyne_tpu/ops/scan.py``: axis swap, NaN and
near-zero filtering, vertical-angle ring binning, the halfPassed
relative-time unwrap, and the ring bucketing as one stable sort by ring
id (stable keeps azimuth order within a ring). The (R, P) grid is read
from the ring-sorted cloud as R contiguous windows by kernel K1
(``ops/grid_kernel.py``). With an IMU window, points are deskewed to
the sweep-start IMU frame after their ring and time are known and before
the bucketing (``ops/imu.py``), so only the coordinates move.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from loam_velodyne_torch.config import LidarConfig, RegistrationConfig
from loam_velodyne_torch.ops.grid_kernel import grid_windows
from loam_velodyne_torch.ops.imu import ImuWindow, project_to_sweep_start
from loam_velodyne_torch.types import PointSet, RingGrid

Tensor = torch.Tensor


class RawSweep(NamedTuple):
    """Raw sweep in the sensor frame (x fwd, y left, z up).

    xyz:  (N, 3) float32, front-packed valid points
    mask: (N,)  bool
    """

    xyz: Tensor
    mask: Tensor


def swap_axes(xyz: Tensor) -> Tensor:
    """Sensor frame -> LOAM camera-style frame: (x, y, z) := (y, z, x)."""
    return torch.stack([xyz[..., 1], xyz[..., 2], xyz[..., 0]], dim=-1)


def ring_for_angle(angle_rad: Tensor, lidar: LidarConfig) -> Tensor:
    """Vertical angle -> ring id (round half to even, as jnp.round)."""
    deg = angle_rad * (180.0 / math.pi)
    return torch.round((deg - lidar.lower_bound_deg) * lidar.factor).to(torch.int32)


def _sweep_orientations(swapped: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Start/end horizontal orientation from the first/last valid point."""
    n = mask.sum().clamp(min=1)
    first = swapped[0]
    last = swapped.index_select(0, (n - 1).reshape(1))[0]
    two_pi = 2 * math.pi
    start_ori = -torch.atan2(first[0], first[2])
    end_ori = -torch.atan2(last[0], last[2]) + two_pi
    span = end_ori - start_ori
    end_ori = torch.where(span > 3 * math.pi, end_ori - two_pi,
                          torch.where(span < math.pi, end_ori + two_pi, end_ori))
    return start_ori, end_ori


def relative_times(swapped: Tensor, mask: Tensor,
                   crossing_mask: Tensor | None = None) -> Tensor:
    """Per-point sweep-relative time fraction in [0, 1] (the halfPassed
    unwrap as 'past the first crossing')."""
    if crossing_mask is None:
        crossing_mask = mask
    start_ori, end_ori = _sweep_orientations(swapped, mask)
    two_pi = 2 * math.pi
    half_pi = math.pi / 2

    ori = -torch.atan2(swapped[:, 0], swapped[:, 2])
    ori_pre = torch.where(ori < start_ori - half_pi, ori + two_pi,
                          torch.where(ori > start_ori + 3 * half_pi,
                                      ori - two_pi, ori))
    crossed = ((ori_pre - start_ori) > math.pi) & crossing_mask
    # torch.argmax returns the first maximal index, as jnp.argmax does.
    first_cross = torch.argmax(crossed.to(torch.int32))
    n_pts = crossed.shape[0]
    half_passed = crossed.any() & (
        torch.arange(n_pts, device=swapped.device) > first_cross)

    ori_post = ori + two_pi
    ori_post = torch.where(ori_post < end_ori - 3 * half_pi, ori_post + two_pi,
                           torch.where(ori_post > end_ori + half_pi,
                                       ori_post - two_pi, ori_post))
    ori_final = torch.where(half_passed, ori_post, ori_pre)
    return (ori_final - start_ori) / (end_ori - start_ori)


def ingest_sweep(raw: RawSweep, lidar: LidarConfig, reg: RegistrationConfig,
                 imu_window: ImuWindow | None = None
                 ) -> Tuple[RingGrid, PointSet]:
    """Filter, bin, time, deskew (with an IMU window) and bucket one
    sweep. Returns the (R, P) ring grid and the flat full-resolution
    cloud in ring-major azimuth order."""
    dev = raw.xyz.device
    n, r_rings = raw.xyz.shape[0], lidar.n_rings
    p_cap = lidar.max_points_per_ring

    swapped = swap_axes(raw.xyz)
    finite = torch.isfinite(swapped).all(dim=-1)
    swapped = torch.where(finite[:, None], swapped, 0.0)
    sq_range = (swapped * swapped).sum(-1)

    vert = torch.atan2(swapped[:, 1],
                       torch.sqrt(swapped[:, 0] ** 2 + swapped[:, 2] ** 2))
    ring = ring_for_angle(vert, lidar)
    valid = (raw.mask & finite & (sq_range >= reg.min_sq_range)
             & (ring >= 0) & (ring < r_rings))

    rel = relative_times(swapped, raw.mask, crossing_mask=valid)
    rel = rel.clamp(0.0, 2.0)
    if imu_window is not None:
        swapped = project_to_sweep_start(swapped, rel * reg.scan_period,
                                         imu_window)

    # Bucket by ring: one stable sort of the ring key, payload gathered.
    ring_key = torch.where(valid, ring, r_rings)
    ring_s, order = torch.sort(ring_key, stable=True)
    xyz_s = swapped[order]
    rel_s = rel[order]
    valid_s = ring_s < r_rings

    counts = torch.zeros(r_rings + 1, dtype=torch.int32, device=dev).scatter_add(
        0, ring_key.long(), torch.ones_like(ring_key))
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    # Rank within ring: row index minus its segment's first row.
    i = torch.arange(n, dtype=torch.int32, device=dev)
    seg_start = F.pad(ring_s[1:] != ring_s[:-1], (1, 0), value=True)
    rank_s = i - torch.cummax(torch.where(seg_start, i, 0), 0).values
    keep_s = valid_s & (rank_s < p_cap)

    grid_count = counts[:r_rings].clamp(max=p_cap)
    grid_mask = (torch.arange(p_cap, device=dev)[None, :]
                 < grid_count[:, None])
    # Column planes padded by one window, so no start ever clamps.
    cols = F.pad(torch.cat([xyz_s.T, rel_s[None, :]]), (0, p_cap))
    g = grid_windows(cols, starts[:r_rings].contiguous(), p_cap)  # (R, 4, P)
    grid_xyz = torch.where(grid_mask[..., None], g[:, :3, :].permute(0, 2, 1),
                           0.0)
    grid_rel = torch.where(grid_mask, g[:, 3, :], 0.0)

    full = PointSet(
        xyz=torch.where(keep_s[:, None], xyz_s, 0.0),
        rel=torch.where(keep_s, rel_s, 0.0),
        ring=torch.where(keep_s, ring_s, 0),
        mask=keep_s)
    grid = RingGrid(xyz=grid_xyz.contiguous(), rel=grid_rel, mask=grid_mask,
                    count=grid_count,
                    dropped=(valid_s & ~keep_s).sum(dtype=torch.int32))
    return grid, full
