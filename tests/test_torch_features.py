"""Port parity, feature stage: loam_velodyne_torch.ops.{voxel,features}
and kernel K2 (ops/greedy_kernel.py) against the JAX package on the CPU.

Tolerances and why:
- K2 labels and marks, feature labels, and the sharp / less-sharp / flat
  clouds: exact. The sweeps are quantized to a 1/128 m grid, which keeps
  every curvature sum exact in float32. On raw float input the two
  frameworks round the curvature differently (XLA sums its cumsum in a
  tree and contracts multiply-adds into FMAs; torch does neither), and
  flat points whose curvature is rounding noise then order differently:
  8 of 464 labels differed on one unquantized VLP-16 sweep (ROADMAP
  queue 3).
- Less-flat centroids and voxel centroids: 1e-6 (observed maximum
  deviation: 0.0). Both sum each cell's points in row order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.config import (VLP16, Capacities, MappingConfig,
                                      RegistrationConfig)
from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.ops import features as jfeat
from loam_velodyne_tpu.ops import scan as jscan
from loam_velodyne_tpu.ops import voxel as jvox
from loam_velodyne_tpu.ops.pallas_greedy import greedy_pick_rows as pallas_greedy
from loam_velodyne_tpu.types import PointSet as JPointSet
from loam_velodyne_torch.ops import features as tfeat
from loam_velodyne_torch.ops import greedy_kernel
from loam_velodyne_torch.ops import voxel as tvox
from loam_velodyne_torch.types import PointSet, RingGrid

REG = RegistrationConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


def _greedy_rows(seed, rows=96, w=384, no_candidates=False):
    rng = np.random.default_rng(seed)
    curv = rng.exponential(0.1, size=(rows, w)).astype(np.float32)
    picked0 = rng.random((rows, w)) < 0.1
    left = rng.integers(0, 6, size=(rows, w)).astype(np.int32)
    right = rng.integers(0, 6, size=(rows, w)).astype(np.int32)
    in_region = rng.random((rows, w)) < (0.0 if no_candidates else 0.9)
    return curv, picked0, left, right, in_region


@pytest.mark.parametrize("corner", [True, False], ids=["corner", "flat"])
@pytest.mark.parametrize("no_candidates", [False, True],
                         ids=["candidates", "empty"])
def test_greedy_plain_matches_pallas(corner, no_candidates):
    curv, picked0, left, right, in_region = _greedy_rows(3, no_candidates=no_candidates)
    steps, quota, sharp = (96, 20, 2) if corner else (64, 4, 0)
    scores = np.where(in_region & ~picked0, curv if corner else -curv, -np.inf)
    top, cand = jax.lax.top_k(jnp.asarray(scores), steps)
    ok = jnp.isfinite(top)
    want = pallas_greedy(jnp.asarray(curv), cand, ok, jnp.asarray(picked0),
                         jnp.asarray(left), jnp.asarray(right), 0.1, quota,
                         sharp, corner, interpret=True)
    got = greedy_kernel.greedy_pick_rows(
        _t(curv), _t(cand).to(torch.int32), _t(ok), _t(picked0), _t(left),
        _t(right), 0.1, quota, sharp, corner)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if not no_candidates:
        assert (got[0].numpy() != 0).any()


@pytest.mark.parametrize("per_ring,capacity", [(True, 4096), (False, 4096),
                                               (True, 300)],
                         ids=["per_ring", "shared", "even_thin"])
def test_voxel_downsample_matches_jax(per_ring, capacity):
    rng = np.random.default_rng(5)
    n = 6000
    xyz = (rng.normal(size=(n, 3)) * 4).astype(np.float32)
    rel = rng.random(n).astype(np.float32)
    ring = rng.integers(0, 16, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    ps = (xyz, rel, ring, mask)
    want, wd = jvox.voxel_downsample(JPointSet(*map(jnp.asarray, ps)), 0.4,
                                     capacity, per_ring=per_ring,
                                     return_dropped=True)
    got, gd = tvox.voxel_downsample(PointSet(*map(_t, ps)), 0.4, capacity,
                                    per_ring=per_ring, return_dropped=True)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.ring.numpy(), np.asarray(want.ring))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), atol=1e-6)
    np.testing.assert_allclose(got.rel.numpy(), np.asarray(want.rel), atol=1e-6)
    assert int(gd) == int(wd)
    if capacity == 300:
        assert int(gd) > 0


def test_voxel_downsample_batched_matches_per_row():
    rng = np.random.default_rng(6)
    b, n = 3, 500
    xyz = (rng.normal(size=(b, n, 3)) * 2).astype(np.float32)
    cnt = np.array([0, 137, 500])
    mask = np.arange(n)[None, :] < cnt[:, None]
    zeros_f = np.zeros((b, n), np.float32)
    zeros_i = np.zeros((b, n), np.int32)
    got = tvox.voxel_downsample(PointSet(_t(xyz), _t(zeros_f), _t(zeros_i),
                                         _t(mask)), 0.2, 256)
    want = jax.vmap(lambda x, m: jvox.voxel_downsample(
        JPointSet(x, jnp.zeros(n), jnp.zeros(n, jnp.int32), m), 0.2, 256))(
        jnp.asarray(xyz), jnp.asarray(mask))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), atol=1e-6)


def _vlp16_grid(seed_sweep=0):
    sweeps, _, _ = synthetic.generate_sequence(
        2, n_azimuth=600, noise_std=0.005,
        traj=synthetic.turning_trajectory())
    pts = np.round(sweeps[seed_sweep] * 128) / 128
    xyz = np.zeros((16384, 3), np.float32)
    mask = np.zeros(16384, bool)
    xyz[:len(pts)], mask[:len(pts)] = pts, True
    grid, _ = jax.jit(lambda x, m: jscan.ingest_sweep(
        jscan.RawSweep(x, m), VLP16, REG))(jnp.asarray(xyz), jnp.asarray(mask))
    return grid


@pytest.mark.parametrize("sweep", [0, 1])
def test_features_match_jax(sweep):
    grid_j = _vlp16_grid(sweep)
    grid_t = RingGrid(*map(_t, grid_j))
    caps = Capacities.for_lidar(VLP16, REG, MappingConfig())

    labels_j, in_region_j = jax.jit(jax.vmap(
        lambda x, n: jfeat._ring_labels(x, n, REG)))(grid_j.xyz, grid_j.count)
    labels_t, in_region_t = tfeat._all_labels(grid_t, REG)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    np.testing.assert_array_equal(in_region_t.numpy(), np.asarray(in_region_j))
    assert (labels_t.numpy() == 2).any() and (labels_t.numpy() == -1).any()

    want = jax.jit(lambda g: jfeat.extract_features(g, REG, caps))(grid_j)
    got = tfeat.extract_features(grid_t, REG, caps)
    for cloud in ("sharp", "less_sharp", "flat"):
        for a, b in zip(getattr(got, cloud), getattr(want, cloud)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), cloud)
    lf_t, lf_j = got.less_flat, want.less_flat
    np.testing.assert_array_equal(lf_t.mask.numpy(), np.asarray(lf_j.mask))
    np.testing.assert_array_equal(lf_t.ring.numpy(), np.asarray(lf_j.ring))
    np.testing.assert_allclose(lf_t.xyz.numpy(), np.asarray(lf_j.xyz), atol=1e-6)
    np.testing.assert_allclose(lf_t.rel.numpy(), np.asarray(lf_j.rel), atol=1e-6)
    assert int(got.dropped) == int(want.dropped)


@pytest.mark.parametrize("fn", ["ring_curvature", "ring_rejection_mask",
                                "suppression_extents"])
def test_ring_helpers_match_jax(fn):
    grid_j = _vlp16_grid()
    c = REG.curvature_region
    want = jax.vmap(lambda x, n: getattr(jfeat, fn)(x, n, c))(grid_j.xyz,
                                                               grid_j.count)
    got = getattr(tfeat, fn)(_t(grid_j.xyz), _t(grid_j.count), c)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_region_bounds_match_jax():
    count = np.array([0, 1, 5, 11, 12, 13, 100, 2047, 2048], np.int32)
    want = jax.vmap(lambda n: jfeat.region_bounds(n, 5, 6))(jnp.asarray(count))
    got = tfeat.region_bounds(_t(count), 5, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
