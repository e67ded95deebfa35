"""Port parity, the IMU path and the dynamic GN schedules:
loam_velodyne_torch.ops.imu, io.imu, the IMU branch of ops.scan, the
IMU terms of models.odometry / models.mapping and their dynamic
schedules, against the JAX package on the CPU.

Tolerances and why:
- ops/imu (interpolate, project_to_sweep_start, sweep_state): 1e-6
  (observed maximum deviation: 4.8e-7; the rotations' sines and
  cosines round differently in the last bit).
- ImuTracker.window_for_sweep: exact (the same float64 numpy, then one
  cast to float32).
- ingest_sweep with a rocking IMU window: grid layout, counts,
  ``dropped``, rings, times and masks exact (the ring and time are
  computed before the deskew); coordinates to 1e-5 (observed maximum
  deviation: 7.6e-6, one float32 step at these ranges).
- One odometry sweep with an IMU state: 1e-4 (observed maximum
  deviation: 1.5e-8), both schedules; its first sweep, which adds the
  IMU's start pitch and roll: 1e-6 (observed: 0). One mapping frame with the IMU
  roll / pitch blend: 5e-3 as in test_torch_mapping (observed maximum
  deviation: 2.2e-3, from one ill-conditioned plane fit; ROADMAP
  queue 3), both schedules. The blend alone (the pose with the IMU on
  minus off): the blend of JAX's formula to 2e-8 (observed: 1.6e-9),
  JAX's own to 1e-5 (observed: 4.4e-6, 0.002 of the solves'
  deviation).
- The port's dynamic schedules against its static ones: bit-equal (the
  same operations on the same inputs, only the loop differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.io.imu import ImuTracker as JTracker
from loam_velodyne_tpu.models import mapping as jmap
from loam_velodyne_tpu.models import odometry as jodo
from loam_velodyne_tpu.ops import features as jfeat
from loam_velodyne_tpu.ops import imu as jimu
from loam_velodyne_tpu.ops import scan as jscan
from loam_velodyne_torch.io.imu import ImuTracker as TTracker
from loam_velodyne_torch.io.synthetic import imu_stream
from loam_velodyne_torch.models import engine as teng
from loam_velodyne_torch.models import mapping as tmap
from loam_velodyne_torch.models import odometry as todo
from loam_velodyne_torch.ops import features as tfeat
from loam_velodyne_torch.ops import imu as timu
from loam_velodyne_torch.ops import scan as tscan
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils.convert import state_from_numpy
from test_torch_engine import _port, _sweeps, slice_config
from test_torch_mapping import map_config

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def trackers(n_sweeps=8, gain=1.0):
    """A JAX and a port tracker fed the same samples."""
    pair = (JTracker(), TTracker())
    for t, rpy, acc in imu_stream(n_sweeps, gain=gain):
        for tr in pair:
            tr.push_state(t, rpy, acc)
    return pair


def _window_np(case):
    """(t, rpy, velo, pos, count) of an 8-state window, as numpy."""
    k = 8
    t = np.full(k, np.inf, np.float32)
    rpy, velo, pos = (np.zeros((k, 3), np.float32) for _ in range(3))
    rng = np.random.default_rng(3)
    if case == "yaw_wrap":
        t[:3] = [0.0, 0.05, 0.1]
        rpy[:3] = [[0.01, 0.0, 3.1], [0.02, 0.01, -3.12], [0.0, 0.0, 3.13]]
        n = 3
    elif case == "empty":
        n = 0
    else:                                  # rocking, with +inf padding
        n = 6 if case == "inf_padding" else 8
        t[:n] = np.sort(rng.uniform(-0.02, 0.12, n)).astype(np.float32)
        rpy[:n] = rng.normal(size=(n, 3)) * 0.05
    velo[:n] = rng.normal(size=(n, 3))
    pos[:n] = rng.normal(size=(n, 3)) * 0.1
    return t, rpy, velo, pos, np.int32(n)


@pytest.mark.parametrize("case", ["rocking", "yaw_wrap", "inf_padding", "empty"])
def test_imu_ops_match_jax(case):
    """interpolate at times before the first state, between states and
    after the last (both clamps), project_to_sweep_start and
    sweep_state."""
    win_np = _window_np(case)
    win_j = jimu.ImuWindow(*map(jnp.asarray, win_np))
    win_t = timu.ImuWindow(*map(_t, win_np))
    times = np.linspace(-0.05, 0.2, 41, dtype=np.float32)
    for got, want in zip(timu.interpolate(win_t, _t(times)),
                         jimu.interpolate(win_j, jnp.asarray(times))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    pts = np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)
    rel = np.linspace(0.0, 0.1, 64, dtype=np.float32)
    got = timu.project_to_sweep_start(_t(pts), _t(rel), win_t)
    want = jimu.project_to_sweep_start(jnp.asarray(pts), jnp.asarray(rel), win_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for got, want in zip(timu.sweep_state(win_t, 0.1), jimu.sweep_state(win_j, 0.1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if case == "empty":
        assert np.array_equal(got.numpy(), np.zeros(3))
        assert torch.equal(timu.project_to_sweep_start(_t(pts), _t(rel), win_t),
                           _t(pts))
    if case == "yaw_wrap":         # through pi, not through zero
        yaw = timu.interpolate(win_t, _t(np.float32([0.025])))[0][0, 2]
        assert abs(abs(float(yaw)) - np.pi) < 0.06


@pytest.mark.parametrize("capacity", [4, 64])
def test_window_for_sweep_matches_jax(capacity):
    j, t = trackers(4)
    raw_j, raw_t = JTracker(), TTracker()
    for k in range(30):       # raw samples, gravity removed by the tracker
        q = (np.sin(0.01 * k), 0.0, 0.0, np.cos(0.01 * k))
        for tr in (raw_j, raw_t):
            tr.push_raw(0.01 * k, q, (0.1, 0.0, 9.81))
    for a, b in zip(timu.ImuWindow.empty(capacity, "cpu"),
                    jimu.ImuWindow.empty(capacity)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for tj, tt in ((j, t), (raw_j, raw_t), (JTracker(), TTracker())):
        for stamp in (-1.0, 0.0, 0.137, 0.25, 5.0):
            want = tj.window_for_sweep(stamp, capacity)
            got = tt.window_for_sweep(stamp, capacity, device="cpu")
            for name, a, b in zip(want._fields, got, want):
                assert a.numpy().dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _ingest_inputs():
    cfg = slice_config()
    xyz, mask, _ = _sweeps(cfg, 1)
    tj, tt = trackers(2, gain=3.0)
    return cfg, xyz[0], mask[0], tj.window_for_sweep(0.1), \
        tt.window_for_sweep(0.1, device="cpu")


def test_ingest_with_imu_matches_jax():
    cfg, xyz, mask, win_j, win_t = _ingest_inputs()
    ingest = jax.jit(lambda r, w: jscan.ingest_sweep(r, cfg.lidar, cfg.registration, w))
    grid_j, full_j = jax.device_get(ingest(jscan.RawSweep(jnp.asarray(xyz),
                                                          jnp.asarray(mask)), win_j))
    pc = _port(cfg)
    grid_t, full_t = tscan.ingest_sweep(tscan.RawSweep(_t(xyz), _t(mask)), pc.lidar,
                                        pc.registration, win_t)
    for name in ("rel", "mask", "count", "dropped"):
        np.testing.assert_array_equal(getattr(grid_t, name).numpy(),
                                      np.asarray(getattr(grid_j, name)), err_msg=name)
    for name in ("rel", "ring", "mask"):
        np.testing.assert_array_equal(getattr(full_t, name).numpy(),
                                      np.asarray(getattr(full_j, name)), err_msg=name)
    np.testing.assert_allclose(grid_t.xyz.numpy(), np.asarray(grid_j.xyz), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(full_t.xyz.numpy(), np.asarray(full_j.xyz), rtol=0,
                               atol=1e-5)
    plain, _ = tscan.ingest_sweep(tscan.RawSweep(_t(xyz), _t(mask)), pc.lidar,
                                  pc.registration)
    assert (plain.xyz - grid_t.xyz).abs().max() > 1e-3        # the deskew moved points


@pytest.fixture(scope="module")
def odometry_inputs():
    """JAX features of three quantized sweeps (bit-equal in the port),
    the odometry state the JAX package reached after two of them, and
    the third sweep's IMU state from a rocking window."""
    cfg = slice_config()
    xyz, mask, _ = _sweeps(cfg, 3)

    @jax.jit
    def feats(x, m):
        grid, _ = jscan.ingest_sweep(jscan.RawSweep(x, m), cfg.lidar, cfg.registration)
        return jfeat.extract_features(grid, cfg.registration, cfg.capacities)

    fj = [feats(jnp.asarray(xyz[i]), jnp.asarray(m_)) for i, m_ in enumerate(mask)]
    tj, _ = trackers(3, gain=3.0)
    imu = [jimu.sweep_state(tj.window_for_sweep(0.1 * i), 0.1) for i in range(3)]
    steps = {s: jax.jit(lambda st, f, i, s=s: jodo.step(st, f, cfg, i, static_schedule=s))
             for s in (True, False)}
    state = jodo.OdometryState.create(cfg)
    for f, i in zip(fj[:2], imu[:2]):
        state, _ = steps[True](state, f, i)
    return cfg, steps, jax.device_get(state), jax.device_get(fj), jax.device_get(imu)


def _features_t(f):
    return tfeat.SweepFeatures(*(PointSet(*map(_t, ps)) for ps in f[:4]),
                               dropped=_t(f.dropped))


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_odometry_step_with_imu_matches_jax(odometry_inputs, static):
    cfg, steps, state, fj, imu = odometry_inputs
    want_state, want = steps[static](state, fj[2], imu[2])
    state_t = state_from_numpy(todo.OdometryState, state, "cpu")
    imu_t = todo.ImuSweepState(*map(_t, imu[2]))
    got_state, got = todo.step(state_t, _features_t(fj[2]), _port(cfg), True, imu_t,
                               static_schedule=static)
    assert np.abs(np.asarray(imu[2].shift_from_start)).max() > 1e-5   # IMU engaged
    np.testing.assert_allclose(got.transform_sum.numpy(),
                               np.asarray(want.transform_sum), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_state.transform.numpy(),
                               np.asarray(want_state.transform), rtol=0, atol=1e-4)
    for a, b in zip(got.corner_cloud, want.corner_cloud):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_odometry_first_sweep_takes_imu_attitude(odometry_inputs):
    cfg, steps, _, fj, imu = odometry_inputs
    want_state, want = steps[False](jodo.OdometryState.create(cfg), fj[0], imu[0])
    got_state, got = todo.step(todo.OdometryState.create(_port(cfg), "cpu"),
                               _features_t(fj[0]), _port(cfg), False,
                               todo.ImuSweepState(*map(_t, imu[0])))
    np.testing.assert_allclose(got.transform_sum.numpy(),
                               np.asarray(want.transform_sum), rtol=0, atol=1e-6)
    assert abs(float(got.transform_sum[0])) > 1e-3


def test_port_dynamic_odometry_gn_equals_static(odometry_inputs):
    cfg, _, state, fj, imu = odometry_inputs
    state_t = state_from_numpy(todo.OdometryState, state, "cpu")
    feats = _features_t(fj[2])
    outs = [todo.run_gauss_newton(feats.sharp, feats.flat, state_t.last_corner,
                                  state_t.last_surf, state_t.transform,
                                  _port(cfg), static_schedule=s) for s in (True, False)]
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] - state_t.transform).abs().max() > 1e-4


@pytest.fixture(scope="module")
def mapping_inputs():
    """A mapping state the JAX package reached after two frames, the
    third frame's inputs and an IMU sweep-end attitude for it."""
    cfg = map_config()
    n_az = 600
    sweeps, gt, _ = synthetic.generate_sequence(
        5, lidar=cfg.lidar, n_azimuth=n_az, noise_std=0.005,
        traj=synthetic.turning_trajectory())

    @jax.jit
    def clouds(x, m):
        grid, _ = jscan.ingest_sweep(jscan.RawSweep(x, m), cfg.lidar, cfg.registration)
        f = jfeat.extract_features(grid, cfg.registration, cfg.capacities)
        return f.less_sharp, f.less_flat

    inputs = []
    for i in (0, 2, 4):
        pts = np.round(sweeps[i] * 256) / 256
        xyz = np.zeros((8 * n_az, 3), np.float32)
        mask = np.zeros(8 * n_az, bool)
        xyz[:len(pts)], mask[:len(pts)] = pts, True
        pose = jnp.asarray([0.0, 0.0, 0.0, *gt[i]], jnp.float32)
        inputs.append((pose,) + clouds(jnp.asarray(xyz), jnp.asarray(mask)))
    steps = {s: jax.jit(lambda st, p, c, f, r, ok, s=s: jmap.step(
        st, p, c, f, cfg, (r, ok), static_schedule=s)) for s in (True, False)}
    rpy = jnp.asarray([0.05, -0.04, 0.3], jnp.float32)
    state = jmap.MappingState.create(cfg)
    for inp in inputs[:2]:          # no IMU data on these frames
        state, _ = steps[False](state, *inp, rpy, jnp.zeros((), bool))
    return cfg, steps, jax.device_get(state), jax.device_get(inputs[2]), rpy


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_mapping_step_with_imu_matches_jax(mapping_inputs, static):
    cfg, steps, state, inp, rpy = mapping_inputs
    ok = jnp.ones((), bool)
    _, want = steps[static](state, *inp, rpy, ok)
    _, want_off = steps[static](state, *inp, rpy, jnp.zeros((), bool))
    pose, corner, surf = inp
    state_t = state_from_numpy(tmap.MappingState, state, "cpu")
    got, got_off = (
        tmap.step(state_t, _t(pose), PointSet(*map(_t, corner)),
                  PointSet(*map(_t, surf)), _port(cfg),
                  (_t(rpy), torch.full((), on, dtype=torch.bool)),
                  static_schedule=static)[1].transform_aft.numpy()
        for on in (True, False))
    np.testing.assert_allclose(got, np.asarray(want.transform_aft), rtol=0, atol=5e-3)
    # The blend alone. JAX's (on - off) is the blend of transformUpdate:
    # 0.002 of the way from the solved roll / pitch (transform[2] / [0])
    # to the IMU's (rpy[0] / rpy[1]). The port's (on - off) is that blend
    # of its own solved pose, and within 1e-5 of JAX's: the deviation is
    # 0.002 of the solves' (observed 4.4e-6), where leaving the blend out
    # moves it by 3.8e-5 and swapping roll and pitch by 1.1e-4.
    b = cfg.mapping.imu_blend
    assert b == np.float32(0.002)

    def blend(off):
        d = np.zeros(6)
        d[0], d[2] = b * (rpy[1] - off[0]), b * (rpy[0] - off[2])
        return d

    want, want_off = np.asarray(want.transform_aft), np.asarray(want_off.transform_aft)
    np.testing.assert_allclose(want - want_off, blend(want_off), rtol=0, atol=2e-8)
    np.testing.assert_allclose(got - got_off, blend(got_off), rtol=0, atol=2e-8)
    np.testing.assert_allclose(got - got_off, want - want_off, rtol=0, atol=1e-5)


def test_port_dynamic_map_gn_equals_static(mapping_inputs):
    cfg, _, state, inp, _ = mapping_inputs
    pc = _port(cfg)
    m = pc.mapping
    state_t = state_from_numpy(tmap.MappingState, state, "cpu")
    pose, corner, surf = inp
    stacks = [tmap.voxel_downsample(PointSet(*map(_t, c)), leaf, cap)
              for c, leaf, cap in ((corner, m.corner_leaf, m.corner_stack_capacity),
                                   (surf, m.surf_leaf, m.surf_stack_capacity))]
    map_c, mask_c = tmap.full_map(state_t, pc)
    n_c = state_t.corner_xyz.shape[0] * state_t.corner_xyz.shape[1]
    tobe = _t(pose) + torch.tensor([0.0, 0.01, 0.0, 0.05, 0.0, -0.05])
    outs = [tmap.optimize_pose(stacks[0], stacks[1], map_c[:n_c], mask_c[:n_c],
                               map_c[n_c:], mask_c[n_c:], tobe, pc,
                               static_schedule=s) for s in (True, False)]
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] - tobe).abs().max() > 1e-3


def test_port_dynamic_engine_equals_static():
    """Eight sweeps through run_chunk: the static cadence with the static
    schedules and the "auto" cadence with the dynamic ones give the same
    outputs, bit for bit, and the same host counters."""
    cfg = _port(slice_config())
    xyz, mask, _ = _sweeps(slice_config(), 8)
    runs = []
    for static in (True, False):
        engine = teng.Engine(cfg, "cpu")
        runs.append((engine.run_chunk(_t(xyz), _t(mask), static_cadence=static),
                     engine.cadence))
    assert torch.equal(runs[0][0].packed, runs[1][0].packed)
    assert runs[0][1] == runs[1][1] == teng.Cadence(8, 4, True)
