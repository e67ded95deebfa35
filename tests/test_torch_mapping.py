"""Port parity, mapping stage: loam_velodyne_torch.ops.{fit,neighbors}
(the windowed 5-NN, kernel K4 in ops/knn_kernel.py) and
models/mapping.py against the JAX package on the CPU.

Tolerances and why:
- K4 and the windowed 5-NN: neighbor columns exact; distances to rtol
  1e-6 (XLA may contract the squared-distance sum into FMAs).
- The map update (recenter, slab insert, re-thin, clip tails, archive
  append, far-point scatter, reinstatement), given the same optimized
  pose: counts, cursors, validity flags and telemetry exact; stored
  coordinates to 1e-5 (observed maximum deviation: 3.8e-6; points are
  mapped by R p + t, whose multiply-adds XLA contracts into FMAs).
- Line fits: validity exact, centroid and direction to 1e-5 (observed
  maximum deviation: 9.5e-7). Plane fits on planes 3 m from the
  origin: validity exact, normal and offset to 1e-3 (observed maximum
  deviation: 4.5e-4). The fit solves float32 normal equations, which
  amplify last-bit rounding differences by their condition number
  (~1e4 even for these planes).
- The optimized pose of one mapping frame: 5e-3 (observed maximum
  deviation: 2.2e-3, for a frame that moved the prior by 9e-2). The
  plane fit solves 3x3 normal equations whose condition number reaches
  1e9 on near-collinear neighborhoods; there, last-bit differences in
  float32 rounding (XLA's FMA contraction against torch's separate
  multiply and add) flip the plane's validity test, and one such plane
  moves the pose by ~1e-3 (ROADMAP queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.config import LidarConfig
from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.models import mapping as jmap
from loam_velodyne_tpu.ops import features as jfeat
from loam_velodyne_tpu.ops import fit as jfit
from loam_velodyne_tpu.ops import neighbors as jnb
from loam_velodyne_tpu.ops import scan as jscan
from loam_velodyne_tpu.ops.pallas_knn import grouped_window_knn as pallas_knn
from loam_velodyne_tpu.parallel.replay import tiny_config
from loam_velodyne_torch.config import LoamConfig as TLoamConfig
from loam_velodyne_torch.models import mapping as tmap
from loam_velodyne_torch.ops import fit as tfit
from loam_velodyne_torch.ops import knn_kernel
from loam_velodyne_torch.ops import neighbors as tnb
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils.convert import state_from_numpy, to_numpy

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _knn_inputs(case):
    rng = np.random.default_rng(7)
    t, g, w = (4, 16, 128) if case != "sentinel" else (1, 8, 64)
    qg = (rng.normal(size=(t, g, 3)) * 5).astype(np.float32)
    win = (rng.normal(size=(t, w, 3)) * 5).astype(np.float32)
    if case == "sentinel":                   # all padding but one point
        win[:] = 1e8
        win[0, 0] = qg[0, 0]
    elif case == "duplicates":               # exact ties: lower column first
        win[:, w // 2:] = win[:, :w // 2]
    return qg, win


@pytest.mark.parametrize("case", ["random", "sentinel", "duplicates"])
def test_knn_plain_matches_pallas(case):
    qg, win = _knn_inputs(case)
    want_d, want_c = pallas_knn(jnp.asarray(qg), jnp.asarray(win), k=5,
                                interpret=True)
    got_d, got_c = knn_kernel.grouped_window_knn(_t(qg), _t(win), 5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    assert (np.diff(got_d.numpy(), axis=-1) >= 0).all()
    if case == "sentinel":
        assert got_d.numpy()[0, 0, 0] < 1e-6 and (got_d.numpy()[0, :, 1:] > 1e6).all()


def test_tiled_windowed_knn_matches_jax():
    rng = np.random.default_rng(8)
    m, q = 3000, 512
    xyz = (rng.normal(size=(m, 3)) * [4, 1, 20]).astype(np.float32)
    mask = rng.random(m) < 0.9
    qx = (xyz[rng.integers(0, m, q)] + rng.normal(size=(q, 3)) * 0.1).astype(np.float32)
    qm = rng.random(q) < 0.9
    ref_j = jnb.sort_cloud(jnp.asarray(xyz), jnp.asarray(mask))
    ref_t = tnb.sort_cloud(_t(xyz), _t(mask))
    for a, b in zip(ref_t[:3], ref_j[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jnb.tiled_windowed_knn(jnp.asarray(qx), jnp.asarray(qm), ref_j, 5,
                                  256, 128, return_neighbors=True)
    got = tnb.tiled_windowed_knn(_t(qx), _t(qm), ref_t, 5, 256, 128,
                                 return_neighbors=True)
    np.testing.assert_array_equal(got[0].numpy()[qm], np.asarray(want[0])[qm])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy()[qm], np.asarray(want[2])[qm])


def _neighborhoods(kind, n=2000):
    rng = np.random.default_rng(9)
    center = rng.normal(size=(n, 1, 3)) * 2
    if kind == "line":
        d = rng.normal(size=(n, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts = center + d * rng.uniform(-1, 1, (n, 5, 1)) \
            + rng.normal(size=(n, 5, 3)) * 0.02
    else:
        # planes 3 m from the origin, 2 m across: the A n = -1 normal
        # equations are well conditioned there
        u = rng.normal(size=(n, 1, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        v = np.cross(u, rng.normal(size=(n, 1, 3)))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        w = np.cross(u, v)
        pts = 3 * u + v * rng.uniform(-1, 1, (n, 5, 1)) \
            + w * rng.uniform(-1, 1, (n, 5, 1)) + rng.normal(size=(n, 5, 3)) * 0.01
    return pts.astype(np.float32)


def test_line_fit_matches_jax():
    nb = _neighborhoods("line")
    want = jfit.line_fit(jnp.asarray(nb), 3.0)
    got = tfit.line_fit(_t(nb), 3.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(np.abs((got[1].numpy() * np.asarray(want[1])).sum(-1)),
                               1.0, atol=1e-5)


def test_plane_fit_matches_jax():
    nb = _neighborhoods("plane")
    want = jfit.plane_fit(jnp.asarray(nb), 0.2)
    got = tfit.plane_fit(_t(nb), 0.2)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    ok = np.asarray(want[2])
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok],
                               rtol=1e-3, atol=0)


def test_select_active_ties_and_budget():
    rng = np.random.default_rng(10)
    flags = rng.random(125) < 0.6
    weight = rng.integers(0, 3, 125).astype(np.int32)        # many ties
    want = jmap._select_active(jnp.asarray(flags), 32, weight=jnp.asarray(weight))
    got = tmap._select_active(_t(flags), 32, weight=_t(weight))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def map_config():
    """tiny_config() with 8 dense rings and map capacities large enough
    for the map GN to engage on a short sequence."""
    base = tiny_config()
    mapping = dataclasses.replace(
        base.mapping, corner_stack_capacity=512, surf_stack_capacity=1024,
        corner_cube_capacity=256, surf_cube_capacity=512, knn_window=256,
        knn_group=64, max_iterations=4, corresp_refresh_every=2)
    lidar = LidarConfig("tiny-dense", -15.0, 15.0, 8, max_points_per_ring=640)
    return dataclasses.replace(base, lidar=lidar, mapping=mapping,
                               capacities=None)


@pytest.fixture(scope="module")
def mapping_frames():
    """A mapping state that the JAX package reached after two frames,
    the third frame's inputs, and the JAX result of that frame."""
    cfg = map_config()
    n_az = 600
    sweeps, gt, _ = synthetic.generate_sequence(
        5, lidar=cfg.lidar, n_azimuth=n_az, noise_std=0.005,
        traj=synthetic.turning_trajectory())

    @jax.jit
    def clouds(x, m):
        grid, _ = jscan.ingest_sweep(jscan.RawSweep(x, m), cfg.lidar,
                                     cfg.registration)
        f = jfeat.extract_features(grid, cfg.registration, cfg.capacities)
        return f.less_sharp, f.less_flat

    def pose(i):
        # a pose near the truth (LOAM frame: x left, y up, z forward)
        return jnp.asarray([0.0, 0.0, 0.0, gt[i, 0], gt[i, 1], gt[i, 2]],
                           jnp.float32)

    inputs = []
    for i in (0, 2, 4):
        pts = np.round(sweeps[i] * 256) / 256
        xyz = np.zeros((8 * n_az, 3), np.float32)
        mask = np.zeros(8 * n_az, bool)
        xyz[:len(pts)], mask[:len(pts)] = pts, True
        inputs.append((pose(i),) + clouds(jnp.asarray(xyz), jnp.asarray(mask)))
    step = jax.jit(lambda s, p, c, f: jmap.step(s, p, c, f, cfg,
                                                static_schedule=True))
    state = jmap.MappingState.create(cfg)
    for inp in inputs[:2]:
        state, _ = step(state, *inp)
    want_state, want_out = step(state, *inputs[2])
    return cfg, jax.device_get(state), jax.device_get(inputs[2]), \
        jax.device_get(want_state), jax.device_get(want_out)


def _run_torch(cfg, state, inp):
    state_t = state_from_numpy(tmap.MappingState, state, "cpu")
    pose, corner, surf = inp
    return tmap.step(state_t, _t(pose), PointSet(*map(_t, corner)),
                     PointSet(*map(_t, surf)),
                     TLoamConfig.from_dict(dataclasses.asdict(cfg)))


def test_mapping_step_pose_matches_jax(mapping_frames):
    cfg, state, inp, want_state, want_out = mapping_frames
    _, got_out = _run_torch(cfg, state, inp)
    moved = np.abs(np.asarray(want_out.transform_aft) - np.asarray(inp[0])).max()
    assert moved > 1e-3                      # the map GN engaged
    np.testing.assert_allclose(got_out.transform_aft.numpy(),
                               np.asarray(want_out.transform_aft),
                               rtol=0, atol=5e-3)


def test_mapping_step_map_update_matches_jax(mapping_frames, monkeypatch):
    """Given the JAX package's optimized pose, the whole map update and
    its telemetry match exactly."""
    cfg, state, inp, want_state, want_out = mapping_frames
    tobe = _t(want_out.transform_aft)
    monkeypatch.setattr(tmap, "optimize_pose", lambda *a, **k: tobe)
    got_state, got_out = _run_torch(cfg, state, inp)
    got_state = to_numpy(got_state)
    for name in tmap.MappingState._fields:
        a, b = getattr(got_state, name), np.asarray(getattr(want_state, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in tmap.MapTelemetry._fields:
        assert int(getattr(got_out.telemetry, name)) == \
            int(getattr(want_out.telemetry, name)), name
    assert bool(got_out.surround_due) == bool(want_out.surround_due)
    assert int(want_state.archive_cnt) > 0        # the archive tier was used
