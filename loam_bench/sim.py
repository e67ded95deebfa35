"""The benchmark's lidar simulator, in torch on the card (a frozen copy).

The geometry of the port's ``io/synthetic.py`` (the corridor world, the
turning trajectory, the azimuth-major raycast with the sensor moving
during the sweep, the ground truth in LOAM's init frame) and the lane
recipe of its ``bench.py::distinct_lanes``, rewritten to make many
sweeps at once on the device. The raycast runs in float64 and returns
float32 points, as the NumPy original does; ``test_lb_sim.py`` holds
the two together without noise. Noise is drawn on the device from a
``torch.Generator``, so the same seed gives the same sweeps.

Sensor frame: x forward, y left, z up. World frame: z up. A point fired
at azimuth a, elevation e has the sensor-frame direction
(cos e cos a, -cos e sin a, sin e).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Lidar:
    """The ring geometry the simulator fires: ``n_rings`` elevations
    evenly from ``lower_deg`` to ``upper_deg``."""

    lower_deg: float
    upper_deg: float
    n_rings: int


@dataclasses.dataclass(frozen=True)
class Turning:
    """Forward motion at ``speed`` with a sustained yaw turn plus an
    oscillation, and a sideways sway: ``synthetic.turning_trajectory``."""

    speed: float = 1.0
    yaw_rate: float = 0.05
    yaw_amp: float = 0.15
    yaw_freq: float = 0.2
    sway_amp: float = 0.8
    sway_freq: float = 0.15

    def __call__(self, t: Tensor):
        """(positions (..., 3), yaw (...)) at times ``t`` (float64)."""
        yaw = (self.yaw_amp * torch.sin(2 * math.pi * self.yaw_freq * t)
               + self.yaw_rate * t)
        pos = torch.stack([self.speed * t,
                           self.sway_amp * torch.sin(2 * math.pi
                                                     * self.sway_freq * t),
                           torch.full_like(t, 1.6)], -1)
        return pos, yaw


def lane_trajectory(b: int, lanes: int, speed: float, recipe: dict) -> Turning:
    """Lane ``b`` of ``lanes`` by ``bench.py::distinct_lanes``' recipe:
    yaw rate ``yaw_rate (1 + yaw_rate_spread b / lanes)``, to the left
    for odd b, sway at ``sway_freq + sway_freq_step b`` Hz."""
    sign = 1 if b % 2 else -1
    return Turning(
        speed=speed,
        yaw_rate=recipe["yaw_rate"] * (1.0 + recipe["yaw_rate_spread"] * b
                                       / lanes) * sign,
        sway_freq=recipe["sway_freq"] + recipe["sway_freq_step"] * b)


def corridor_world(length: float, pillar_spacing: float, width: float = 8.0,
                   height: float = 5.0) -> np.ndarray:
    """``synthetic.corridor_world`` as an (n, 6) float64 array of
    rectangles (axis, offset, u_min, u_max, v_min, v_max): a corridor
    along +x with floor, ceiling, side, end and back walls, and box
    pillars alternating along the sides every ~``pillar_spacing`` m from
    x = 8 to ``length`` - 8 (sizes from the original's generator)."""
    n_pillars = max(2, int(round((length - 16.0) / pillar_spacing)) + 1)
    w2 = width / 2
    rects = [
        (1, -w2, 0.0, height, -5.0, length), (1, +w2, 0.0, height, -5.0, length),
        (2, 0.0, -5.0, length, -w2, w2), (2, height, -5.0, length, -w2, w2),
        (0, length, -w2, w2, 0.0, height), (0, -5.0, -w2, w2, 0.0, height),
    ]
    rng = np.random.default_rng(7)
    for i in range(n_pillars):
        cx = 8.0 + i * (length - 16.0) / max(n_pillars - 1, 1)
        cy = (w2 - 1.5) * (1 if i % 2 == 0 else -1)
        s = 0.4 + 0.3 * rng.random()
        x0, x1, y0, y1, z0, z1 = cx - s, cx + s, cy - s, cy + s, 0.0, \
            2.5 + rng.random()
        rects += [(0, x0, y0, y1, z0, z1), (0, x1, y0, y1, z0, z1),
                  (1, y0, z0, z1, x0, x1), (1, y1, z0, z1, x0, x1),
                  (2, z0, x0, x1, y0, y1), (2, z1, x0, x1, y0, y1)]
    return np.asarray(rects, np.float64)


def _raycast(origins: Tensor, dirs: Tensor, rects: np.ndarray,
             max_range: float = 100.0) -> Tensor:
    """First-hit distances (...,) of rays (..., 3), inf where nothing is
    hit (``synthetic._raycast``)."""
    best = torch.full(origins.shape[:-1], math.inf, dtype=torch.float64,
                      device=origins.device)
    for axis, offset, u_min, u_max, v_min, v_max in rects.tolist():
        a = int(axis)
        u, v = (a + 1) % 3, (a + 2) % 3
        t = (offset - origins[..., a]) / dirs[..., a]
        pu = origins[..., u] + t * dirs[..., u]
        pv = origins[..., v] + t * dirs[..., v]
        ok = ((t > 0.15) & (t < max_range) & torch.isfinite(t)
              & (pu >= u_min) & (pu <= u_max) & (pv >= v_min) & (pv <= v_max))
        best = torch.where(ok & (t < best), t, best)
    return best


def sweeps(rects: np.ndarray, traj: Turning, t0s: Tensor, lidar: Lidar,
           n_azimuth: int, cap: int, noise_std: float = 0.0,
           generator: torch.Generator | None = None,
           scan_period: float = 0.1):
    """One revolution from each start time ``t0s`` (S,): (xyz (S, cap, 3)
    float32, mask (S, cap) bool, counts (S,)), each sweep's returns
    azimuth-major (all rings of one firing together, the lowest first)
    and motion-distorted, non-returns dropped, as
    ``synthetic.raycast_sweep``; past ``cap`` rows a sweep is cut."""
    dev = t0s.device
    f64 = dict(dtype=torch.float64, device=dev)
    elev = torch.deg2rad(torch.linspace(lidar.lower_deg, lidar.upper_deg,
                                        lidar.n_rings, **f64))
    az = 2 * math.pi * torch.arange(n_azimuth, **f64) / n_azimuth
    ce, se = torch.cos(elev), torch.sin(elev)
    ca, sa = torch.cos(az), torch.sin(az)
    dirs_s = torch.stack([torch.outer(ca, ce), torch.outer(-sa, ce),
                          se.expand(n_azimuth, lidar.n_rings)], -1)  # (A, R, 3)
    times = (t0s[:, None]
             + scan_period * torch.arange(n_azimuth, **f64)[None] / n_azimuth)
    pos, yaw = traj(times)                                   # (S, A, 3), (S, A)
    cy, sy = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    dx = dirs_s[..., 0] * cy - dirs_s[..., 1] * sy
    dy = dirs_s[..., 0] * sy + dirs_s[..., 1] * cy
    dz = dirs_s[..., 2].expand_as(dx)
    dirs_w = torch.stack([dx, dy, dz], -1)                   # (S, A, R, 3)
    origins = pos[:, :, None, :].expand_as(dirs_w)
    dist = _raycast(origins, dirs_w, rects)                  # (S, A, R)
    if noise_std > 0:
        dist = dist + noise_std * torch.randn(dist.shape, generator=generator,
                                              **f64)
    s = t0s.shape[0]
    hit = torch.isfinite(dist).reshape(s, -1)
    pts = (dirs_s[None] * dist[..., None]).reshape(s, -1, 3).to(torch.float32)
    slot = torch.cumsum(hit.to(torch.int64), 1) - 1
    keep = hit & (slot < cap)
    xyz = torch.zeros((s, cap, 3), dtype=torch.float32, device=dev)
    mask = torch.zeros((s, cap), dtype=torch.bool, device=dev)
    rows = torch.arange(s, device=dev)[:, None].expand_as(slot)
    xyz[rows[keep], slot[keep]] = pts[keep]
    mask[rows[keep], slot[keep]] = True
    return xyz, mask, hit.sum(1)


def loam_frame_positions(traj: Turning, times: np.ndarray) -> np.ndarray:
    """Ground-truth sensor positions at ``times`` in the LOAM init frame of
    ``times[0]`` (x left, y up, z forward): ``synthetic.loam_frame_positions``."""
    t = torch.as_tensor(np.asarray(times, np.float64))
    pos, yaw = traj(t)
    pos, yaw = pos.numpy(), yaw.numpy()
    c, s = np.cos(-yaw[0]), np.sin(-yaw[0])
    d = pos - pos[0]
    rel = np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1],
                    d[:, 2]], 1)
    return np.stack([rel[:, 1], rel[:, 2], rel[:, 0]], 1)


def ground_truth(traj: Turning, t_start: float, n: int,
                 scan_period: float = 0.1) -> np.ndarray:
    """(n, 3) positions at the ends of n sweeps from ``t_start``, in the
    init frame of ``t_start`` (``synthetic.generate_sequence``'s)."""
    times = t_start + scan_period * np.arange(n + 1)
    return loam_frame_positions(traj, times)[1:]


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Aligned absolute trajectory error (m): RMSE over positions after a
    rigid Umeyama alignment of ``est`` onto ``gt`` (a frozen copy of the
    port's ``eval/metrics.py::ate_rmse(..., align=True)``)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    cov = (gt - mu_g).T @ (est - mu_e) / len(est)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    err = est @ r.T + (mu_g - r @ mu_e) - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the whole numbers ``key``
    (the run's seed, a lane, a bag): any seed, negative or past 64 bits,
    gives a generator of its own."""
    words = [k % (1 << 64) for k in key]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g
