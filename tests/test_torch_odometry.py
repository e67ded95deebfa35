"""Port parity, odometry stage: loam_velodyne_torch.ops.neighbors (the
correspondence search, kernel K3 in ops/corresp_kernel.py) and
models/odometry.py against the JAX package on the CPU.

Tolerances and why:
- K3 and the brute-force searches: match indices exactly. Distances to
  rtol 1e-6 (observed maximum deviation: 0.0): XLA may contract the
  squared-distance sum into FMAs, torch does not.
- One odometry step from a state the JAX package reached: poses and
  end-frame clouds to 1e-4 rad / 1e-4 m (observed maximum deviation:
  7.5e-9 for the pose, 3.8e-6 m for the clouds). Both run
  the same Gauss-Newton, but the 6x6 normal equations are summed and
  solved by different libraries, so the pose differs in the last bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.config import LidarConfig, LoamConfig
from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.models import odometry as jodo
from loam_velodyne_tpu.ops import features as jfeat
from loam_velodyne_tpu.ops import neighbors as jnb
from loam_velodyne_tpu.ops import scan as jscan
from loam_velodyne_tpu.ops.pallas_corresp import _corresp_call
from loam_velodyne_tpu.parallel.replay import tiny_config
from loam_velodyne_tpu.types import PointSet as JPointSet
from loam_velodyne_torch.config import LoamConfig as TLoamConfig
from loam_velodyne_torch.models import odometry as todo
from loam_velodyne_torch.ops import corresp_kernel
from loam_velodyne_torch.ops import features as tfeat
from loam_velodyne_torch.ops import neighbors as tnb
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils.convert import state_from_numpy

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, m, n_rings=16, frac_valid=0.8, scale=5.0):
    xyz = rng.normal(size=(m, 3)).astype(np.float32) * scale
    ring = rng.integers(0, n_rings, size=m).astype(np.int32)
    mask = rng.random(m) < frac_valid
    xyz[~mask] = 0.0
    return xyz, np.zeros(m, np.float32), ring, mask


def _queries(rng, q, frac_valid=0.9, scale=5.0, offset=0.0):
    xyz = rng.normal(size=(q, 3)).astype(np.float32) * scale + offset
    return xyz.astype(np.float32), rng.random(q) < frac_valid


# The five cases of tests/test_pallas_corresp.py: random corner, random
# surf, a dense cloud, an empty mask, and queries beyond the gate.
CASES = {
    "corner": dict(surf=False, q=256, m=1920, frac=0.8, scale=5.0, rings=16),
    "surf": dict(surf=True, q=384, m=2048, frac=0.8, scale=5.0, rings=16),
    "dense": dict(surf=True, q=128, m=1024, frac=1.0, scale=1.0, rings=4),
    "empty_mask": dict(surf=False, q=128, m=512, frac=0.0, scale=5.0, rings=16),
    "beyond_gate": dict(surf=False, q=128, m=512, frac=1.0, scale=5.0,
                        rings=16, offset=100.0),
}


def _case(name):
    c = CASES[name]
    rng = np.random.default_rng(11)
    q_xyz, q_mask = _queries(rng, c["q"], scale=c["scale"],
                             offset=c.get("offset", 0.0))
    cloud = _cloud(rng, c["m"], c["rings"], c["frac"], c["scale"])
    return c, q_xyz, q_mask, cloud


@pytest.mark.parametrize("name", list(CASES))
def test_corresp_plain_matches_pallas(name):
    c, q_xyz, _, (xyz, _, ring, mask) = _case(name)
    want = _corresp_call(jnp.asarray(q_xyz), jnp.asarray(xyz),
                         jnp.asarray(ring), jnp.asarray(mask), bracket=2.5,
                         surf_mode=c["surf"], interpret=True)
    got = corresp_kernel.corresp_search(_t(q_xyz), _t(xyz), _t(ring),
                                        _t(mask), 2.5, c["surf"])
    for i in (0, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_allclose(got[i + 1].numpy(), np.asarray(want[i + 1]),
                                   rtol=1e-6)
    if name == "empty_mask":
        assert np.isinf(got[1].numpy()).all() and (got[0].numpy() == 0).all()


@pytest.mark.parametrize("name", ["corner", "surf", "dense", "beyond_gate"])
def test_correspondences_match_jax_bruteforce(name):
    c, q_xyz, q_mask, cloud = _case(name)
    last_j = JPointSet(*map(jnp.asarray, cloud))
    last_t = PointSet(*map(_t, cloud))
    kind = "surf" if c["surf"] else "corner"
    want = getattr(jnb, f"{kind}_correspondences")(jnp.asarray(q_xyz),
                                                   jnp.asarray(q_mask), last_j)
    brute = getattr(tnb, f"{kind}_correspondences")(_t(q_xyz), _t(q_mask), last_t)
    fused = getattr(tnb, f"{kind}_correspondences_fused")(_t(q_xyz), _t(q_mask),
                                                          last_t)
    valid = np.asarray(want.valid)
    for got in (brute, fused):
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        for f in want._fields[:-1]:
            np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                          np.asarray(getattr(want, f))[valid])
    np.testing.assert_array_equal(brute.j.numpy(), np.asarray(want.j))
    if name == "dense":
        assert valid.any()


def small_config() -> LoamConfig:
    """tiny_config() with 8 rings of 640 points (dense enough rings for
    real features at 600 azimuth steps) and correspondences refreshed
    every GN iteration (a short static schedule keeps the JAX compile
    short)."""
    base = tiny_config()
    lidar = LidarConfig("tiny-dense", -15.0, 15.0, 8, max_points_per_ring=640)
    odo = dataclasses.replace(base.odometry, corresp_refresh_every=1)
    return dataclasses.replace(base, lidar=lidar, odometry=odo, capacities=None)


def _sweeps(cfg, k, n_azimuth=600):
    sweeps, gt, _ = synthetic.generate_sequence(
        k, lidar=cfg.lidar, n_azimuth=n_azimuth, noise_std=0.005,
        traj=synthetic.turning_trajectory())
    cap = cfg.lidar.n_rings * n_azimuth
    xyz = np.zeros((k, cap, 3), np.float32)
    mask = np.zeros((k, cap), bool)
    for i, pts in enumerate(sweeps):
        pts = np.round(pts * 256) / 256
        xyz[i, :len(pts)], mask[i, :len(pts)] = pts, True
    return xyz, mask, gt


def _features_t(f):
    return tfeat.SweepFeatures(*(PointSet(*map(_t, ps)) for ps in f[:4]),
                               dropped=_t(f.dropped))


def test_odometry_step_matches_jax():
    cfg = small_config()
    xyz, mask, _ = _sweeps(cfg, 3)

    @jax.jit
    def feats(x, m):
        grid, _ = jscan.ingest_sweep(jscan.RawSweep(x, m), cfg.lidar,
                                     cfg.registration)
        return jfeat.extract_features(grid, cfg.registration, cfg.capacities)

    step = jax.jit(lambda s, f: jodo.step(s, f, cfg, static_schedule=True))
    fj = [feats(jnp.asarray(xyz[i]), jnp.asarray(m_)) for i, m_ in enumerate(mask)]
    state = jodo.OdometryState.create(cfg)
    for f in fj[:2]:
        state, _ = step(state, f)
    want_state, want = step(state, fj[2])

    state_t = state_from_numpy(todo.OdometryState, jax.device_get(state), "cpu")
    got_state, got = todo.step(state_t, _features_t(jax.device_get(fj[2])),
                               TLoamConfig.from_dict(dataclasses.asdict(cfg)),
                               initialized=True)
    np.testing.assert_allclose(got.transform_sum.numpy(),
                               np.asarray(want.transform_sum), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_state.transform.numpy(),
                               np.asarray(want_state.transform), rtol=0, atol=1e-4)
    assert np.abs(np.asarray(want_state.transform)).max() > 1e-3   # it moved
    for a, b in zip(got.surf_cloud, want.surf_cloud):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    assert int(got_state.frame) == int(want_state.frame)


def test_odometry_first_sweep_adopts_clouds():
    cfg = TLoamConfig.from_dict(dataclasses.asdict(small_config()))
    state = todo.OdometryState.create(cfg, "cpu")
    feats = tfeat.SweepFeatures(*(PointSet.empty(n, "cpu") for n in (
        cfg.capacities.sharp, cfg.capacities.less_sharp, cfg.capacities.flat,
        cfg.capacities.less_flat)), dropped=torch.zeros((), dtype=torch.int32))
    new, outs = todo.step(state, feats, cfg, initialized=False)
    assert bool(new.initialized) and int(new.frame) == 1
    assert torch.equal(outs.transform_sum, state.transform_sum)
