"""Port parity, the whole slice: loam_velodyne_torch.models.engine (with
fusion, utils/math and utils/convert) against the JAX package's
``run_chunk(static_cadence=True)`` on the CPU.

Tolerances and why:
- Per-sweep odom / mapped / fused poses: 1e-4 rad / 1e-4 m (observed
  maximum deviation: 1.5e-7). The inputs are quantized to a 1/256 m grid,
  so ingest and features are bit-identical; the Gauss-Newton solves
  differ in the last bits (different BLAS / LAPACK).
- The (29,) packed vector's flags, telemetry counters and archive
  cursor: exact.
- Pose math (utils/math): 1e-6 (observed maximum deviation: 2.4e-7);
  trigonometric functions round differently in the last bit.
- The state carried by utils/convert: exact, both ways.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.config import LidarConfig, LoamConfig
from loam_velodyne_tpu.eval.metrics import ate_rmse
from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.models import engine as jeng
from loam_velodyne_tpu.models import fusion as jfusion
from loam_velodyne_tpu.ops.scan import RawSweep as JRaw
from loam_velodyne_tpu.parallel.replay import tiny_config
from loam_velodyne_tpu.utils import math as jlm
from loam_velodyne_torch.config import LoamConfig as TLoamConfig
from loam_velodyne_torch.models import engine as teng
from loam_velodyne_torch.models import fusion as tfusion
from loam_velodyne_torch.ops.scan import RawSweep as TRaw
from loam_velodyne_torch.utils import math as tlm
from loam_velodyne_torch.utils.convert import (engine_state_from_numpy,
                                               engine_state_to_numpy)

N_SWEEPS = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def slice_config() -> LoamConfig:
    """tiny_config() with 8 rings of 640 points (dense enough for real
    features at 600 azimuth steps) and short GN schedules (correspondences
    refreshed every iteration), which keep the JAX compile short."""
    base = tiny_config()
    lidar = LidarConfig("tiny-dense", -15.0, 15.0, 8, max_points_per_ring=640)
    odo = dataclasses.replace(base.odometry, corresp_refresh_every=1)
    mapping = dataclasses.replace(base.mapping, max_iterations=2,
                                  corresp_refresh_every=1)
    return dataclasses.replace(base, lidar=lidar, odometry=odo,
                               mapping=mapping, capacities=None)


def _port(cfg: LoamConfig) -> TLoamConfig:
    """The port's own configuration with the same fields."""
    return TLoamConfig.from_dict(dataclasses.asdict(cfg))


def _sweeps(cfg, k, n_azimuth=600, quantum=256):
    sweeps, gt, _ = synthetic.generate_sequence(
        k, lidar=cfg.lidar, n_azimuth=n_azimuth, noise_std=0.005,
        traj=synthetic.turning_trajectory())
    cap = cfg.lidar.n_rings * n_azimuth
    xyz = np.zeros((k, cap, 3), np.float32)
    mask = np.zeros((k, cap), bool)
    for i, pts in enumerate(sweeps):
        pts = np.round(pts * quantum) / quantum
        xyz[i, :len(pts)], mask[i, :len(pts)] = pts, True
    return xyz, mask, gt


@pytest.fixture(scope="module")
def slice_run():
    cfg = slice_config()
    xyz, mask, gt = _sweeps(cfg, N_SWEEPS)
    run = jax.jit(lambda s, r: jeng.run_chunk(s, r, cfg, static_cadence=True))
    state_j, outs_j = run(jeng.EngineState.create(cfg),
                          JRaw(jnp.asarray(xyz), jnp.asarray(mask)))
    state_t, outs_t = teng.run_chunk(teng.EngineState.create(_port(cfg), "cpu"),
                                     TRaw(_t(xyz), _t(mask)), _port(cfg))
    return (cfg, xyz, mask, gt, jax.device_get(state_j), jax.device_get(outs_j),
            state_t, outs_t)


def test_slice_matches_jax(slice_run):
    cfg, _, _, gt, _, outs_j, _, outs_t = slice_run
    for name in ("odom_pose", "mapped_pose", "fused_pose"):
        np.testing.assert_allclose(getattr(outs_t, name).numpy(),
                                   np.asarray(getattr(outs_j, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    packed_t, packed_j = outs_t.packed.numpy(), np.asarray(outs_j.packed)
    np.testing.assert_allclose(packed_t[:, :18], packed_j[:, :18], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(packed_t[:, 18:], packed_j[:, 18:])
    tel_t = jax.tree_util.tree_leaves(outs_t.telemetry)
    tel_j = jax.tree_util.tree_leaves(outs_j.telemetry)
    for a, b in zip(tel_t, tel_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(outs_t.mapping_ran.numpy(),
                                  np.arange(N_SWEEPS) % 2 == 1)
    assert np.abs(packed_j[-1, 12:18]).max() > 0.1      # the sensor moved
    assert packed_j[:, 20:28].sum() > 0                 # telemetry exercised
    ate_j = ate_rmse(packed_j[:, 15:18], gt, align=True)
    ate_t = ate_rmse(packed_t[:, 15:18], gt, align=True)
    assert abs(ate_t - ate_j) < 1e-4


def test_convert_round_trip(slice_run):
    state_j = slice_run[4]
    back = engine_state_to_numpy(engine_state_from_numpy(state_j, "cpu"))
    leaves_j = jax.tree_util.tree_leaves(state_j)
    leaves_b = jax.tree_util.tree_leaves(back)
    assert len(leaves_j) == len(leaves_b)
    for a, b in zip(leaves_j, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_slice_final_state_matches_jax(slice_run):
    """The carried state after the chunk: counters and map occupancy
    exact, poses to 1e-4."""
    state_j, state_t = slice_run[4], engine_state_to_numpy(slice_run[6])
    for name in ("corner_cnt", "surf_cnt", "origin", "map_frame",
                 "archive_cnt", "archive_cursor", "archive_valid"):
        np.testing.assert_array_equal(getattr(state_t.mapping, name),
                                      np.asarray(getattr(state_j.mapping, name)),
                                      err_msg=name)
    assert int(state_t.sweep) == int(state_j.sweep) == N_SWEEPS
    assert int(state_t.mapping_inputs) == int(state_j.mapping_inputs)
    np.testing.assert_allclose(state_t.odometry.transform_sum,
                               np.asarray(state_j.odometry.transform_sum),
                               rtol=0, atol=1e-4)


def test_engine_chunks_equal_one_run(slice_run):
    """Engine keeps the host-side sweep counter across chunks: two
    chunks of 4 give the run of one chunk of 8."""
    cfg, xyz, mask, _, _, _, _, outs_t = slice_run
    engine = teng.Engine(_port(cfg), "cpu")
    packed = torch.cat([engine.run_chunk(_t(xyz[s:s + 4]), _t(mask[s:s + 4])).packed
                        for s in (0, 4)])
    assert engine.sweep == N_SWEEPS
    assert torch.equal(packed, outs_t.packed)


def test_run_chunk_rejects_misaligned_chunks():
    cfg = _port(slice_config())
    raws = TRaw(torch.zeros((3, 16, 3)), torch.zeros((3, 16), dtype=torch.bool))
    with pytest.raises(ValueError):
        teng.run_chunk(teng.EngineState.create(cfg, "cpu"), raws, cfg)
    with pytest.raises(ValueError):
        teng.step(teng.EngineState.create(cfg, "cpu"),
                  TRaw(raws.xyz[0], raws.mask[0]), cfg, "on", teng.Cadence())


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 6)).astype(np.float32)


MATH_CASES = {
    "pose_rot_mat": lambda m, p: m.pose_rot_mat(p[0]),
    "euler_yxz": lambda m, p: m.euler_yxz(m.pose_rot_mat(p[0])),
    "transform_points": lambda m, p: m.pose_transform_points(p[0], p[1][:, 3:]),
    "inverse_transform": lambda m, p: m.pose_inverse_transform_points(
        p[0], p[1][:, 3:]),
    "accumulate_rotation": lambda m, p: m.accumulate_rotation(p[0][:3], p[1][0, :3]),
    "plugin_imu_rotation": lambda m, p: m.plugin_imu_rotation(
        p[0][:3], p[1][0, :3], p[1][1, :3]),
    "associate_to_map": lambda m, p: m.transform_associate_to_map(p[0], p[1][0],
                                                                  p[1][1]),
    "to_start": lambda m, p: m.transform_to_start(p[1][:, 3:], p[1][:, 0] * 0.5
                                                  + 0.5, p[0]),
    "to_end": lambda m, p: m.transform_to_end(p[1][:, 3:], p[1][:, 0] * 0.5 + 0.5,
                                              p[0], p[1][2, :3], p[1][3, :3],
                                              p[1][4, 3:]),
}


@pytest.mark.parametrize("name", list(MATH_CASES))
def test_pose_math_matches_jax(name):
    poses = _poses(12)
    args_j = (jnp.asarray(poses[0]), jnp.asarray(poses))
    args_t = (_t(poses[0]), _t(poses))
    want = MATH_CASES[name](jlm, args_j)
    got = MATH_CASES[name](tlm, args_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_fusion_matches_jax():
    poses = _poses(13, 3)
    st_j = jfusion.FusionState(jnp.asarray(poses[0]), jnp.asarray(poses[1]))
    st_t = tfusion.update_mapping(tfusion.FusionState.create("cpu"),
                                  _t(poses[0]), _t(poses[1]))
    np.testing.assert_allclose(tfusion.fuse(st_t, _t(poses[2])).numpy(),
                               np.asarray(jfusion.fuse(st_j, jnp.asarray(poses[2]))),
                               rtol=0, atol=1e-6)


@pytest.mark.slow
def test_vlp16_full_width_slice_matches_jax():
    """The VLP-16 preset at datasheet capacities, 4 sweeps. Poses to 5e-3
    and the archive cursor to 1%: at this width the map GN engages, an
    ill-conditioned plane fit can move a mapped pose by ~1e-3 (see
    test_torch_mapping), and slab tails then spill a few different rows
    into the archive. Observed (CPU, this tree): maximum pose deviation
    1.07e-3; archive rows 0/489/489/1,674 against the JAX package's
    0/489/489/1,671 (0.18%). Flags and the telemetry counters (all zero
    at these capacities) must match exactly. Peak memory ~2.4 GB, ~100 s."""
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, _ = _sweeps(cfg, 4, n_azimuth=900, quantum=128)
    run = jax.jit(lambda s, r: jeng.run_chunk(s, r, cfg, static_cadence=True))
    _, outs_j = run(jeng.EngineState.create(cfg),
                    JRaw(jnp.asarray(xyz), jnp.asarray(mask)))
    _, outs_t = teng.run_chunk(teng.EngineState.create(_port(cfg), "cpu"),
                               TRaw(_t(xyz), _t(mask)), _port(cfg))
    packed_j = np.asarray(outs_j.packed)
    packed_t = outs_t.packed.numpy()
    np.testing.assert_allclose(packed_t[:, :18], packed_j[:, :18], rtol=0,
                               atol=5e-3)
    np.testing.assert_array_equal(packed_t[:, 18:28], packed_j[:, 18:28])
    np.testing.assert_allclose(packed_t[:, 28], packed_j[:, 28], rtol=1e-2)
