"""Synthetic Velodyne sweep generator (host-side, numpy), the same
simulator as ``loam_velodyne_tpu/io/synthetic.py`` (sweep for sweep
equal, tests/test_torch_config.py).

A deterministic raycast simulator: a corridor of axis-aligned
rectangles (walls give planar "surf" structure, box pillars give
vertical-edge "corner" structure), a smooth ground-truth trajectory,
and a spinning lidar that fires azimuth-major like a real VLP-16,
with motion distortion (each firing is measured in the sensor frame at
its own timestamp).

Sensor frame: x forward, y left, z up. World frame: z up.
A point fired at azimuth a, elevation e has sensor-frame direction
(cos e cos a, -cos e sin a, sin e), so the LOAM ingest orientation
-atan2(y, x) == a increases monotonically over the sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np

from loam_velodyne_torch.config import VLP16, LidarConfig

Trajectory = Callable[[float], Tuple[np.ndarray, float]]


@dataclasses.dataclass(frozen=True)
class Rect:
    """Axis-aligned rectangle: plane {x_axis = offset}, bounded on the
    two remaining axes."""

    axis: int          # 0=x, 1=y, 2=z (plane normal direction)
    offset: float
    u_min: float
    u_max: float
    v_min: float
    v_max: float

    @property
    def u_axis(self) -> int:
        return (self.axis + 1) % 3

    @property
    def v_axis(self) -> int:
        return (self.axis + 2) % 3


def box(x0, x1, y0, y1, z0, z1) -> List[Rect]:
    """Six rectangles of an axis-aligned box."""
    return [
        Rect(0, x0, y0, y1, z0, z1), Rect(0, x1, y0, y1, z0, z1),
        Rect(1, y0, z0, z1, x0, x1), Rect(1, y1, z0, z1, x0, x1),
        Rect(2, z0, x0, x1, y0, y1), Rect(2, z1, x0, x1, y0, y1),
    ]


def corridor_world(length: float = 60.0, width: float = 8.0,
                   height: float = 5.0, n_pillars: int = 6) -> List[Rect]:
    """A corridor along +x with floor/ceiling/side walls, an end wall,
    and box pillars alternating along the sides (edge features)."""
    w2 = width / 2
    rects = [
        Rect(1, -w2, 0.0, height, -5.0, length),   # right wall
        Rect(1, +w2, 0.0, height, -5.0, length),   # left wall
        Rect(2, 0.0, -5.0, length, -w2, w2),       # floor
        Rect(2, height, -5.0, length, -w2, w2),    # ceiling
        Rect(0, length, -w2, w2, 0.0, height),     # end wall
        Rect(0, -5.0, -w2, w2, 0.0, height),       # back wall
    ]
    rng = np.random.default_rng(7)
    for i in range(n_pillars):
        cx = 8.0 + i * (length - 16.0) / max(n_pillars - 1, 1)
        cy = (w2 - 1.5) * (1 if i % 2 == 0 else -1)
        s = 0.4 + 0.3 * rng.random()
        rects += box(cx - s, cx + s, cy - s, cy + s, 0.0, 2.5 + rng.random())
    return rects


def straight_trajectory(speed: float = 1.0, yaw_amp: float = 0.08,
                        yaw_freq: float = 0.35,
                        sway_amp: float = 0.25) -> Trajectory:
    """Smooth forward motion with gentle sway and yaw wobble:
    traj(t) -> (position (3,), yaw) in the world frame."""

    def traj(t: float):
        pos = np.array([speed * t,
                        sway_amp * np.sin(2 * np.pi * yaw_freq * t),
                        1.6], np.float64)
        yaw = yaw_amp * np.sin(2 * np.pi * yaw_freq * t + 0.5)
        return pos, yaw

    return traj


def turning_trajectory(speed: float = 1.0, yaw_rate: float = 0.05,
                       yaw_amp: float = 0.15, yaw_freq: float = 0.2,
                       sway_amp: float = 0.8, sway_freq: float = 0.15
                       ) -> Trajectory:
    """Forward motion with a sustained yaw turn plus oscillation (the
    benchmark trajectory: it exercises rotation estimation)."""

    def traj(t: float):
        yaw = yaw_amp * np.sin(2 * np.pi * yaw_freq * t) + yaw_rate * t
        pos = np.array([speed * t,
                        sway_amp * np.sin(2 * np.pi * sway_freq * t),
                        1.6], np.float64)
        return pos, yaw

    return traj


def _raycast(origins: np.ndarray, dirs: np.ndarray,
             rects: List[Rect], max_range: float = 100.0) -> np.ndarray:
    """Vectorized first-hit raycast. origins/dirs: (N, 3). Returns hit
    distances (N,), inf where nothing was hit."""
    n = origins.shape[0]
    best = np.full(n, np.inf)
    for r in rects:
        d_axis = dirs[:, r.axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (r.offset - origins[:, r.axis]) / d_axis
        pu = origins[:, r.u_axis] + t * dirs[:, r.u_axis]
        pv = origins[:, r.v_axis] + t * dirs[:, r.v_axis]
        ok = ((t > 0.15) & (t < max_range) & np.isfinite(t)
              & (pu >= r.u_min) & (pu <= r.u_max)
              & (pv >= r.v_min) & (pv <= r.v_max))
        best = np.where(ok & (t < best), t, best)
    return best


def raycast_sweep(rects: List[Rect], traj: Trajectory, t0: float,
                  lidar: LidarConfig = VLP16, n_azimuth: int = 900,
                  scan_period: float = 0.1, noise_std: float = 0.0,
                  seed: int = 0) -> np.ndarray:
    """Simulate one full revolution starting at time t0.

    Returns (N, 3) float32 sensor-frame points, azimuth-major (all rings
    of one firing consecutive, low ring first), motion-distorted, with
    non-returns dropped.
    """
    elev = np.deg2rad(np.linspace(lidar.lower_bound_deg, lidar.upper_bound_deg,
                                  lidar.n_rings))
    az = 2 * np.pi * np.arange(n_azimuth) / n_azimuth
    times = t0 + scan_period * np.arange(n_azimuth) / n_azimuth

    # (A, R, 3) sensor-frame directions, azimuth-major.
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    dirs_sensor = np.stack([
        np.outer(ca, ce), np.outer(-sa, ce),
        np.broadcast_to(se, (n_azimuth, lidar.n_rings)),
    ], axis=-1)

    pos = np.stack([traj(t)[0] for t in times])          # (A, 3)
    yaw = np.array([traj(t)[1] for t in times])           # (A,)
    cy, sy = np.cos(yaw), np.sin(yaw)
    # World-frame directions: Rz(yaw) @ dir.
    dx = dirs_sensor[..., 0] * cy[:, None] - dirs_sensor[..., 1] * sy[:, None]
    dy = dirs_sensor[..., 0] * sy[:, None] + dirs_sensor[..., 1] * cy[:, None]
    dz = dirs_sensor[..., 2]
    dirs_world = np.stack([dx, dy, dz], axis=-1).reshape(-1, 3)
    origins = np.repeat(pos, lidar.n_rings, axis=0)

    dist = _raycast(origins, dirs_world, rects)
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        dist = dist + rng.normal(0.0, noise_std, dist.shape)

    hit = np.isfinite(dist)
    pts_sensor = dirs_sensor.reshape(-1, 3) * dist[:, None]
    return pts_sensor[hit].astype(np.float32)


def loam_frame_positions(traj: Trajectory, times: np.ndarray) -> np.ndarray:
    """Ground-truth sensor positions in the LOAM init frame: the
    axis-swapped sensor frame at times[0] (x=left, y=up, z=forward)."""
    p0, yaw0 = traj(times[0])
    c, s = np.cos(-yaw0), np.sin(-yaw0)
    out = []
    for t in times:
        p, _ = traj(t)
        d = p - p0
        rel = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1], d[2]])
        out.append([rel[1], rel[2], rel[0]])
    return np.asarray(out, np.float64)


def generate_sequence(n_sweeps: int, lidar: LidarConfig = VLP16,
                      n_azimuth: int = 900, scan_period: float = 0.1,
                      speed: float = 1.0, noise_std: float = 0.0,
                      world: List[Rect] | None = None,
                      traj: Trajectory | None = None):
    """Generate a sweep sequence + ground truth.

    Returns (sweeps, gt_positions, times): sweeps is a list of (N_i, 3)
    float32 arrays; gt_positions is (n_sweeps, 3) in the LOAM init
    frame, evaluated at each sweep END time (LOAM's odometry pose
    timestamps correspond to sweep end).
    """
    rects = corridor_world() if world is None else world
    if traj is None:
        traj = straight_trajectory(speed=speed)
    sweeps = [raycast_sweep(rects, traj, i * scan_period, lidar, n_azimuth,
                            scan_period, noise_std, seed=i)
              for i in range(n_sweeps)]
    end_times = scan_period * (np.arange(n_sweeps) + 1)
    gt = loam_frame_positions(traj, np.concatenate([[0.0], end_times]))[1:]
    return sweeps, gt, end_times


def bench_sweeps(n_sweeps: int, lidar: LidarConfig = VLP16,
                 n_azimuth: int = 900):
    """The benchmark sequence (noisy turning trajectory at 1 m/s, 5 mm
    of noise, each sweep's from its own seed), unpadded: (sweeps, each
    (N_i, 3) float32; gt_positions (n, 3)). The input of
    tests/test_oracle.py's VLP-16 gates."""
    sweeps, gt, _ = generate_sequence(
        n_sweeps, lidar=lidar, n_azimuth=n_azimuth, speed=1.0,
        noise_std=0.005, traj=turning_trajectory(speed=1.0))
    return sweeps, gt


def noisy_turning(n_sweeps: int, lidar: LidarConfig, seed: int, speed: float):
    """The turning trajectory at ``speed`` (900 azimuths), with 5 mm of
    point noise drawn from one generator seeded by ``seed``: a sequence
    of its own for every seed and speed (sweeps, each (N_i, 3) float32;
    gt_positions (n, 3))."""
    sweeps, gt, _ = generate_sequence(
        n_sweeps, lidar=lidar, n_azimuth=900, speed=speed,
        traj=turning_trajectory(speed=speed))
    rng = np.random.default_rng(seed)
    return [(pts + rng.normal(0.0, 0.005, pts.shape)).astype(np.float32)
            for pts in sweeps], gt


def pad_sweeps(sweeps: list, cap: int):
    """(N_i, 3) sweeps, each padded to (or cut at) ``cap`` rows: (xyz
    (n, cap, 3) float32, mask (n, cap) bool)."""
    xyz = np.zeros((len(sweeps), cap, 3), np.float32)
    mask = np.zeros((len(sweeps), cap), bool)
    for i, pts in enumerate(sweeps):
        k = min(len(pts), cap)
        xyz[i, :k], mask[i, :k] = pts[:k], True
    return xyz, mask


def bench_sequence(n_sweeps: int, lidar: LidarConfig = VLP16, cap: int = 32768,
                   n_azimuth: int = 900):
    """The benchmark sequence (``bench_sweeps``), each sweep padded to
    ``cap`` rows: (xyz (n, cap, 3) float32, mask (n, cap) bool,
    gt_positions (n, 3))."""
    sweeps, gt = bench_sweeps(n_sweeps, lidar, n_azimuth)
    return (*pad_sweeps(sweeps, cap), gt)


def imu_stream(n_sweeps: int, rate_hz: float = 100.0, t0: float = -0.2,
               gain: float = 1.0):
    """A rocking-attitude IMU stream for the sweeps of ``bench_sequence``:
    (stamp, (roll, pitch, yaw), swapped gravity-free acceleration)
    samples from ``t0`` to 0.2 s past the last sweep; a copy of the
    stream of tests/test_oracle.py."""
    out = []
    for t in np.arange(t0, n_sweeps * 0.1 + 0.2, 1.0 / rate_hz):
        out.append((float(t), (gain * 0.02 * np.sin(7.0 * t),
                               gain * 0.015 * np.cos(5.0 * t), 0.0),
                    (gain * 0.05 * np.sin(3.0 * t),
                     gain * 0.02 * np.cos(4.0 * t), 0.0)))
    return out
