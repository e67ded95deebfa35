"""The port's own configuration, trajectory metric and sweep simulator
(loam_velodyne_torch.config, .eval.metrics, .io.synthetic) against the
JAX package's, on the CPU.

Tolerances: none. The configurations must be equal field for field
(derived capacities included), the simulated sweeps and ground truth
bit for bit (the same numpy code on the same seeds), and the ATE to
the last bit (the same float64 numpy arithmetic).
"""

import dataclasses

import numpy as np
import pytest
import torch

from loam_velodyne_tpu import config as jconfig
from loam_velodyne_tpu.eval import metrics as jmetrics
from loam_velodyne_tpu.io import synthetic as jsyn
from loam_velodyne_tpu.parallel.replay import tiny_config
from loam_velodyne_torch import config as tconfig
from loam_velodyne_torch.eval import metrics as tmetrics
from loam_velodyne_torch.io import synthetic as tsyn

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

CLASSES = ["LidarConfig", "RegistrationConfig", "OdometryConfig",
           "MappingConfig", "Capacities", "LoamConfig"]


def _fields(cls):
    def plain(v):
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return [(f.name, f.type, plain(f.default)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_config_classes_have_the_same_fields(name):
    assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))


@pytest.mark.parametrize("preset", ["VLP-16", "HDL-32", "HDL-64E"])
def test_presets_match_jax(preset):
    want = dataclasses.asdict(jconfig.LoamConfig.preset(preset))
    got = tconfig.LoamConfig.preset(preset)
    assert dataclasses.asdict(got) == want
    assert tconfig.LoamConfig.from_dict(want) == got
    assert got.registration.max_corner_less_sharp == 20
    assert got.mapping.n_cubes == jconfig.LoamConfig.preset(preset).mapping.n_cubes


def test_from_dict_carries_a_reduced_config():
    cfg = tiny_config()
    got = tconfig.LoamConfig.from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    assert got.mapping.n_neighborhood_cubes == cfg.mapping.n_neighborhood_cubes


@pytest.mark.parametrize("cls,kwargs", [
    ("RegistrationConfig", {"corner_scan_cap": 8}),
    ("MappingConfig", {"grid_width": 4}),
    ("MappingConfig", {"archive_capacity": 16}),
])
def test_config_validation_matches_jax(cls, kwargs):
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            getattr(mod, cls)(**kwargs)


@pytest.mark.parametrize("turning,noise", [(True, 0.005), (False, 0.0)])
def test_synthetic_sequence_matches_jax(turning, noise):
    lidar_j = jconfig.LidarConfig("tiny", -15.0, 15.0, 8, max_points_per_ring=128)
    lidar_t = tconfig.LidarConfig("tiny", -15.0, 15.0, 8, max_points_per_ring=128)
    kw = dict(n_azimuth=120, noise_std=noise)
    sw_j, gt_j, t_j = jsyn.generate_sequence(
        3, lidar=lidar_j, traj=jsyn.turning_trajectory() if turning else None, **kw)
    sw_t, gt_t, t_t = tsyn.generate_sequence(
        3, lidar=lidar_t, traj=tsyn.turning_trajectory() if turning else None, **kw)
    assert len(sw_t) == len(sw_j)
    for a, b in zip(sw_t, sw_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gt_t, gt_j)
    np.testing.assert_array_equal(t_t, t_j)


def test_bench_sequence_pads_the_simulated_sweeps():
    lidar = tconfig.LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=64)
    xyz, mask, gt = tsyn.bench_sequence(2, lidar, cap=300, n_azimuth=64)
    sweeps, gt_j, _ = jsyn.generate_sequence(
        2, lidar=jconfig.LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=64),
        n_azimuth=64, speed=1.0, noise_std=0.005,
        traj=jsyn.turning_trajectory(speed=1.0))
    assert xyz.shape == (2, 300, 3) and mask.shape == (2, 300)
    for i, pts in enumerate(sweeps):
        n = len(pts)
        assert 0 < n <= 300 and mask[i].sum() == n
        np.testing.assert_array_equal(xyz[i, :n], pts)
        assert not xyz[i, n:].any()
    np.testing.assert_array_equal(gt, gt_j)


@pytest.mark.parametrize("align", [False, True])
def test_ate_matches_jax(align):
    rng = np.random.default_rng(5)
    gt = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    est = gt @ np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]).T
    est = est + rng.normal(scale=0.05, size=est.shape) + 3.0
    got = tmetrics.ate_rmse(est, gt, align=align)
    assert got == jmetrics.ate_rmse(est, gt, align=align)
    if align:
        assert got < 0.2                # the rotation and offset are removed


def test_sized_for_stream_buckets_ring_capacity():
    """tests/test_config.py's sized_for_stream case on the port: the
    128-aligned ring bucket covering the observed density (with margin),
    capped at the datasheet preset, at least 128, and the derived
    capacities recomputed (the quota-driven feature capacities
    untouched)."""
    cfg = tconfig.LoamConfig.preset("HDL-64E")
    sized = cfg.sized_for_stream(57600)    # 900 a ring, x 1.25 = 1125
    assert sized.lidar.max_points_per_ring == 1152
    assert sized.capacities.full_cloud == 64 * 1152
    assert sized.capacities.sharp == cfg.capacities.sharp
    assert sized.capacities.less_sharp == cfg.capacities.less_sharp
    assert (cfg.sized_for_stream(10_000_000).lidar.max_points_per_ring
            == cfg.lidar.max_points_per_ring)
    assert cfg.sized_for_stream(1).lidar.max_points_per_ring == 128


@pytest.mark.parametrize("points", [1, 14_400, 57_600, 10_000_000])
@pytest.mark.parametrize("preset", ["VLP-16", "HDL-32", "HDL-64E"])
def test_sized_for_stream_matches_jax(preset, points):
    want = jconfig.LoamConfig.preset(preset).sized_for_stream(points)
    got = tconfig.LoamConfig.preset(preset).sized_for_stream(points)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    margin = tconfig.LoamConfig.preset(preset).sized_for_stream(points, 2.0)
    assert (dataclasses.asdict(margin) == dataclasses.asdict(
        jconfig.LoamConfig.preset(preset).sized_for_stream(points, 2.0)))


def test_stream_cap_pads_the_densest_sweep_to_128():
    """``config.stream_cap``, bench.py's padding: the densest sweep
    rounded up to a multiple of 128, at least 128 (the bench's VLP-16
    stream of 14,400-point sweeps: 14,464)."""
    def sweeps(*sizes):
        return [np.zeros((n, 3), np.float32) for n in sizes]
    assert tconfig.stream_cap(sweeps(0, 1)) == 128
    assert tconfig.stream_cap(sweeps(128)) == 128
    assert tconfig.stream_cap(sweeps(5, 129, 7)) == 256
    assert tconfig.stream_cap(sweeps(14_400, 13_000)) == 14_464
