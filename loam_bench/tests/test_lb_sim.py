"""The benchmark's torch simulator against the port's NumPy simulator
(``io/synthetic.py``), without noise, at a small size on the CPU."""

import numpy as np
import pytest
import torch

from loam_bench import sim
from loam_velodyne_torch.config import HDL64E, VLP16
from loam_velodyne_torch.io import synthetic

torch.set_num_threads(1)


def test_corridor_world_is_the_originals():
    ref = [[r.axis, r.offset, r.u_min, r.u_max, r.v_min, r.v_max]
           for r in synthetic.corridor_world()]
    np.testing.assert_array_equal(sim.corridor_world(60.0, 8.8),
                                  np.asarray(ref))


@pytest.mark.parametrize("lidar, n_azimuth", [(VLP16, 180), (HDL64E, 60)])
def test_sweeps_equal_the_numpy_raycast(lidar, n_azimuth):
    world = synthetic.corridor_world()
    traj_np = synthetic.turning_trajectory(speed=1.0, yaw_rate=-0.05,
                                           sway_freq=0.17)
    traj = sim.Turning(speed=1.0, yaw_rate=-0.05, sway_freq=0.17)
    t0 = torch.tensor([0.0, 0.7, 2.3], dtype=torch.float64)
    xyz, mask, counts = sim.sweeps(
        sim.corridor_world(60.0, 8.8), traj, t0,
        sim.Lidar(lidar.lower_bound_deg, lidar.upper_bound_deg,
                  lidar.n_rings), n_azimuth, 16384)
    for i, t in enumerate(t0.tolist()):
        ref = synthetic.raycast_sweep(world, traj_np, t, lidar, n_azimuth)
        n = int(counts[i])
        assert n == len(ref) == int(mask[i].sum())
        np.testing.assert_array_equal(xyz[i, :n].numpy(), ref)


def test_ground_truth_is_the_originals():
    traj_np = synthetic.turning_trajectory(speed=1.0)
    _, gt, _ = synthetic.generate_sequence(5, n_azimuth=36, traj=traj_np)
    np.testing.assert_allclose(sim.ground_truth(sim.Turning(), 0.0, 5), gt,
                               rtol=0, atol=1e-12)


def test_lane_recipe_is_the_bench_recipe():
    recipe = {"yaw_rate": 0.05, "yaw_rate_spread": 0.4, "sway_freq": 0.15,
              "sway_freq_step": 0.02}
    for b in range(8):
        t = sim.lane_trajectory(b, 8, 1.0, recipe)
        assert t.yaw_rate == pytest.approx(
            0.05 * (1.0 + 0.4 * b / 8) * (1 if b % 2 else -1))
        assert t.sway_freq == pytest.approx(0.15 + 0.02 * b)


def test_noise_follows_the_seed():
    world = sim.corridor_world(30.0, 8.8)
    lid = sim.Lidar(-15.0, 15.0, 4)
    t0 = torch.zeros(1, dtype=torch.float64)

    def draw(*key):
        return sim.sweeps(world, sim.Turning(), t0, lid, 32, 256, 0.005,
                          sim.generator("cpu", *key))[0]

    assert torch.equal(draw(2 ** 31 + 11, 0), draw(2 ** 31 + 11, 0))
    assert not torch.equal(draw(2 ** 31 + 11, 0), draw(2 ** 31 + 12, 0))
    assert not torch.equal(draw(5, 0), draw(5, 1))
    draw(-3, 0)
