"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a configuration's sensor (``configs/<name>.json``) become lanes of
simulated sweeps, made on the card from the run's seed.

Every lane drives its own recorded run: lane b follows
``sim.lane_trajectory(b, ...)`` down a corridor ``world_length_m`` long
for ``drive_sweeps`` sweeps (``drive_sweeps`` x 0.1 s). A lane replays
its drive as bags of ``bag_sweeps`` consecutive sweeps, each processed
from a fresh state: the drive cut into whole bags that follow each other
and start again from the first (the lanes aligned).

The seed draws the point noise; the trajectories, the world and the bag
lengths are the mix's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from loam_bench import sim

SCAN_PERIOD = 0.1
BLOCK = 48            # sweeps raycast at once


@dataclasses.dataclass
class Sensor:
    lidar: sim.Lidar
    n_azimuth: int
    cap: int
    speed: float
    noise_std: float
    pillar_spacing: float


def sensor(config: dict) -> Sensor:
    """The simulated sensor and motion of a configuration file."""
    lid = config["loam"]["lidar"]
    return Sensor(sim.Lidar(lid["lower_bound_deg"], lid["upper_bound_deg"],
                            lid["n_rings"]),
                  int(config["n_azimuth"]), int(config["sweep_capacity"]),
                  float(config["speed_m_per_s"]), float(config["noise_std_m"]),
                  float(config["pillar_spacing_m"]))


def trajectories(traffic: dict, s: Sensor) -> List[sim.Turning]:
    lanes = int(traffic["lanes"])
    return [sim.lane_trajectory(b, lanes, s.speed, traffic["lane_recipe"])
            for b in range(lanes)]


def bags(traffic: dict) -> Iterator[Tuple[int, int]]:
    """The bags of a lane's drive, (first sweep, length), without end."""
    drive, n = int(traffic["drive_sweeps"]), int(traffic["bag_sweeps"])
    if n > drive:
        raise ValueError(f"a bag of {n} sweeps is longer than the drive "
                         f"({drive})")
    while True:
        for start in range(0, drive - n + 1, n):
            yield start, n


def drives_on_card(traffic: dict, s: Sensor, seed: int, device,
                   n_sweeps: int | None = None):
    """Every lane's drive padded on ``device``: (xyz (B, D, cap, 3) float32,
    mask (B, D, cap) bool, points a sweep (B, D))."""
    world = sim.corridor_world(float(traffic["world_length_m"]),
                               s.pillar_spacing)
    d = int(n_sweeps or traffic["drive_sweeps"])
    lanes = trajectories(traffic, s)
    xyz = torch.zeros((len(lanes), d, s.cap, 3), dtype=torch.float32,
                      device=device)
    mask = torch.zeros((len(lanes), d, s.cap), dtype=torch.bool, device=device)
    counts = torch.zeros((len(lanes), d), dtype=torch.int64, device=device)
    for b, traj in enumerate(lanes):
        gen = sim.generator(device, seed, b)
        for k in range(0, d, BLOCK):
            t0 = SCAN_PERIOD * torch.arange(k, min(k + BLOCK, d),
                                            dtype=torch.float64, device=device)
            x, m, c = sim.sweeps(world, traj, t0, s.lidar, s.n_azimuth, s.cap,
                                 s.noise_std, gen, SCAN_PERIOD)
            xyz[b, k:k + len(t0)], mask[b, k:k + len(t0)] = x, m
            counts[b, k:k + len(t0)] = c
    return xyz, mask, counts


def drive_on_host(traffic: dict, s: Sensor, seed: int, device,
                  lane: int = 0, n_sweeps: int | None = None) -> List[np.ndarray]:
    """One lane's drive as the sweeps a sensor driver hands over: a list
    of (N_i, 3) float32 host arrays (made on ``device``)."""
    world = sim.corridor_world(float(traffic["world_length_m"]),
                               s.pillar_spacing)
    d = int(n_sweeps or traffic["drive_sweeps"])
    traj = trajectories(traffic, s)[lane]
    gen = sim.generator(device, seed, lane)
    out = []
    for k in range(0, d, BLOCK):
        t0 = SCAN_PERIOD * torch.arange(k, min(k + BLOCK, d),
                                        dtype=torch.float64, device=device)
        x, _, c = sim.sweeps(world, traj, t0, s.lidar, s.n_azimuth, s.cap,
                             s.noise_std, gen, SCAN_PERIOD)
        x, c = x.cpu().numpy(), c.cpu().numpy()
        out += [x[i, :min(int(c[i]), s.cap)] for i in range(len(c))]
    return out


def ground_truth(traffic: dict, s: Sensor, lane: int, start: int,
                 n: int) -> np.ndarray:
    """(n, 3) positions of a bag's first n sweeps in its own init frame."""
    traj = trajectories(traffic, s)[lane]
    return sim.ground_truth(traj, start * SCAN_PERIOD, n, SCAN_PERIOD)
