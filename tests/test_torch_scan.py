"""Port parity, ingest stage: loam_velodyne_torch.ops.scan and kernel K1
(ops/grid_kernel.py) against the JAX package on the CPU.

Tolerance: none. K1 only moves data, and the ring grid, the full
cloud, the ring ids and the drop count must match the JAX package
exactly. The relative times come from atan2 on both sides, whose
implementations may round differently in the last bit; they are held to
1e-6 (observed maximum deviation: 0.0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.config import VLP16, LidarConfig, RegistrationConfig
from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.ops import scan as jscan
from loam_velodyne_tpu.ops.pallas_grid import grid_windows as pallas_grid_windows
from loam_velodyne_torch.ops import grid_kernel
from loam_velodyne_torch.ops import scan as tscan

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

REG = RegistrationConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["ragged", "empty_and_duplicate"])
def test_grid_windows_plain_matches_pallas(case):
    rng = np.random.default_rng(0)
    if case == "ragged":
        c, n, p = 4, 4096, 512
        cols = rng.normal(size=(c, n + p + 128)).astype(np.float32)
        starts = np.sort(rng.integers(0, n, size=16)).astype(np.int32)
        starts[0], starts[-1] = 0, n
    else:
        c, n, p = 4, 1024, 256
        cols = np.arange(c * (n + p + 128), dtype=np.float32).reshape(c, -1)
        starts = np.asarray([0, 0, 7, 7, 1024, 1024], np.int32)
    want = pallas_grid_windows(jnp.asarray(cols), jnp.asarray(starts), p,
                               interpret=True)
    got = grid_kernel.grid_windows(_t(cols), _t(starts), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_swap_axes_and_ring_for_angle():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(500, 3)).astype(np.float32) * 10
    np.testing.assert_array_equal(tscan.swap_axes(_t(xyz)).numpy(),
                                  np.asarray(jscan.swap_axes(jnp.asarray(xyz))))
    ang = np.deg2rad(rng.uniform(-20, 20, 2000)).astype(np.float32)
    np.testing.assert_array_equal(
        tscan.ring_for_angle(_t(ang), VLP16).numpy(),
        np.asarray(jscan.ring_for_angle(jnp.asarray(ang), VLP16)))


def _padded_sweep(pts, cap, quantum=128):
    # Coordinates on a 1/quantum m grid keep every sum of the feature
    # stage exact, whatever the summation order (see test_torch_features).
    pts = np.round(pts * quantum) / quantum
    xyz = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    xyz[:len(pts)], mask[:len(pts)] = pts, True
    return xyz, mask


@pytest.mark.parametrize("lidar", [
    VLP16,
    # ring capacity below the ring's point count: drops must match
    LidarConfig("narrow", -15.0, 15.0, 16, max_points_per_ring=256),
], ids=["vlp16", "ring_overflow"])
def test_ingest_matches_jax(lidar):
    sweeps, _, _ = synthetic.generate_sequence(1, n_azimuth=600,
                                               noise_std=0.01)
    xyz, mask = _padded_sweep(sweeps[0], 16384)
    xyz[5] = np.nan                         # a NaN return is filtered
    grid_j, full_j = jax.jit(lambda x, m: jscan.ingest_sweep(
        jscan.RawSweep(x, m), lidar, REG))(jnp.asarray(xyz), jnp.asarray(mask))
    grid_t, full_t = tscan.ingest_sweep(tscan.RawSweep(_t(xyz), _t(mask)),
                                        lidar, REG)
    for name in ("xyz", "mask", "count", "dropped"):
        np.testing.assert_array_equal(getattr(grid_t, name).numpy(),
                                      np.asarray(getattr(grid_j, name)), name)
    np.testing.assert_allclose(grid_t.rel.numpy(), np.asarray(grid_j.rel),
                               rtol=0, atol=1e-6)
    for name in ("xyz", "ring", "mask"):
        np.testing.assert_array_equal(getattr(full_t, name).numpy(),
                                      np.asarray(getattr(full_j, name)), name)
    np.testing.assert_allclose(full_t.rel.numpy(), np.asarray(full_j.rel),
                               rtol=0, atol=1e-6)
    if lidar.max_points_per_ring == 256:
        assert int(grid_t.dropped) > 0
    assert int(grid_t.count.sum()) > 0


def test_relative_times_matches_jax():
    sweeps, _, _ = synthetic.generate_sequence(1, n_azimuth=300)
    xyz, mask = _padded_sweep(sweeps[0], 8192)
    sw = np.asarray(jscan.swap_axes(jnp.asarray(xyz)))
    want = jscan.relative_times(jnp.asarray(sw), jnp.asarray(mask))
    got = tscan.relative_times(_t(sw), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
