"""Robustness counterparts of the port at ``slice_config()`` shapes:
tests/test_robustness.py (a sensor dropout mid-sequence, the map
recentering during a run) and the overflow counters of
tests/test_telemetry.py, run through the port on the CPU.

- The empty sweep: the JAX package's static-cadence chunk (one program,
  compiled once in a module fixture) and the port's on the same 8
  quantized sweeps with sweep 3 empty. Poses to 1e-4, the tolerance of
  tests/test_torch_engine.py (observed maximum deviation: 2.4e-7; the
  inputs are quantized, so ingest and features are exact, and the
  Gauss-Newton solves round differently); flags, counters and the
  archive cursor exact. The batched replay carries the dropout in one
  lane only.
- Recentering and the counters: the JAX tests' own checks, on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.io import synthetic
from loam_velodyne_tpu.models import engine as jeng
from loam_velodyne_tpu.ops.scan import RawSweep as JRaw
from loam_velodyne_torch.eval.metrics import ate_rmse
from loam_velodyne_torch.models import engine as teng
from loam_velodyne_torch.ops.scan import RawSweep as TRaw
from loam_velodyne_torch.parallel import replay as treplay
from test_torch_engine import _port, _sweeps, slice_config

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

N = 8
EMPTY = 3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def dropout():
    cfg = slice_config()
    xyz, mask, gt = _sweeps(cfg, N)
    xyz[EMPTY], mask[EMPTY] = 0.0, False
    run = jax.jit(lambda s, r: jeng.run_chunk(s, r, cfg, static_cadence=True))
    _, outs_j = run(jeng.EngineState.create(cfg),
                    JRaw(jnp.asarray(xyz), jnp.asarray(mask)))
    pc = _port(cfg)
    _, outs_t = teng.run_chunk(teng.EngineState.create(pc, "cpu"),
                               TRaw(_t(xyz), _t(mask)), pc)
    full_xyz, full_mask, _ = _sweeps(cfg, N)
    _, full = teng.run_chunk(teng.EngineState.create(pc, "cpu"),
                             TRaw(_t(full_xyz), _t(full_mask)), pc)
    return (cfg, xyz, mask, gt, np.asarray(outs_j.packed), outs_t.packed,
            (full_xyz, full_mask, full.packed))


def test_empty_sweep_matches_jax(dropout):
    _, _, _, _, packed_j, packed_t, _ = dropout
    p = packed_t.numpy()
    np.testing.assert_allclose(p[:, :18], packed_j[:, :18], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(p[:, 18:], packed_j[:, 18:])
    assert not p[EMPTY + 1:, 18].all() and p[EMPTY, 18]   # the cadence held


def test_empty_sweep_does_not_poison_state(dropout):
    """tests/test_robustness.py:52 on the port: no NaN, the trajectory
    recovers. The JAX test holds the final position within 0.4 m of the
    ground truth at VLP-16; at these shapes (8 rings, 3 GN iterations)
    the run without the dropout itself ends 0.60 m off, so the final
    position is held within 0.4 m of that run's (observed: 0.09 m)."""
    p = dropout[5].numpy()
    full = dropout[6][2].numpy()
    assert np.isfinite(p).all()
    assert np.linalg.norm(p[-1, 15:18] - full[-1, 15:18]) < 0.4
    assert p[EMPTY, 20] == 0                      # nothing to drop


def test_empty_sweep_in_one_lane_of_the_batched_replay(dropout):
    """Lane 1 carries the dropout, lane 0 the full sequence: each lane
    equals its single-stream run (poses to 1e-6, the rest exact; the
    tolerance of tests/test_torch_replay.py)."""
    cfg, xyz, mask, _, _, packed_t, (full_xyz, full_mask, full) = dropout
    pc = _port(cfg)
    chunk = treplay.make_batched_chunk(pc)
    _, outs = chunk(treplay.create_states(pc, 2, "cpu"),
                    TRaw(_t(np.stack([full_xyz, xyz])),
                         _t(np.stack([full_mask, mask]))))
    for got, want in ((outs.packed[0], full), (outs.packed[1], packed_t)):
        np.testing.assert_allclose(got[:, :18].numpy(), want[:, :18].numpy(),
                                   rtol=0, atol=1e-6)
        assert torch.equal(got[:, 18:], want[:, 18:])


def test_recenter_fires_during_run():
    """tests/test_robustness.py:17 on the port: 2.5 m cubes, so the
    window recenters within a short run. The JAX test drives VLP-16 5 m/s
    through a 9x5x9 window (8.75 m to the recenter); at these shapes the
    3-iteration odometry cannot follow 0.5 m a sweep, so it runs 10 GN
    iterations at 2 m/s through a 9x5x5 window (3.75 m to the recenter)
    for 22 sweeps (4.4 m; observed: one shift, ATE 6.0 cm)."""
    base = slice_config()
    mapping = dataclasses.replace(
        base.mapping, cube_size=2.5, grid_width=9, grid_height=5,
        grid_depth=5, center_width=4, center_height=2, center_depth=2,
        recenter_margin=1, neighborhood=1)
    odo = dataclasses.replace(base.odometry, max_iterations=10)
    cfg = _port(dataclasses.replace(base, mapping=mapping, odometry=odo,
                                    capacities=None))
    traj = synthetic.straight_trajectory(speed=2.0, yaw_amp=0.0, sway_amp=0.0)
    sweeps, gt, _ = synthetic.generate_sequence(22, lidar=base.lidar,
                                                n_azimuth=600, traj=traj)
    cap = base.lidar.n_rings * 600
    xyz = np.zeros((22, cap, 3), np.float32)
    mask = np.zeros((22, cap), bool)
    for i, pts in enumerate(sweeps):
        xyz[i, :len(pts)], mask[i, :len(pts)] = pts, True
    engine = teng.Engine(cfg, "cpu")
    origin0 = engine.state.mapping.origin.clone()
    packed = engine.run_chunk(_t(xyz), _t(mask)).packed.numpy()
    origin1 = engine.state.mapping.origin
    assert origin1[2] > origin0[2], (origin0, origin1)
    assert np.isfinite(packed).all()
    assert ate_rmse(packed[:, 15:18], gt, align=True) < 0.5


def _step_engine(cfg, n_sweeps, n_pts=192, seed=0, scale=4.0):
    """tests/test_telemetry.py::_step_engine on the port: random sweeps
    through Engine.step (the "auto" cadence, dynamic schedules)."""
    rng = np.random.default_rng(seed)
    engine = teng.Engine(_port(cfg), "cpu")
    outs = []
    for _ in range(n_sweeps):
        pts = rng.uniform(-scale, scale, (n_pts, 3)).astype(np.float32)
        outs.append(engine.step(_t(pts), torch.ones(n_pts, dtype=torch.bool)))
    return outs


def test_ingest_overflow_counter():
    """Points beyond the per-ring row capacity are counted."""
    from loam_velodyne_tpu.parallel.replay import tiny_config
    outs = _step_engine(tiny_config(), 1, n_pts=1024, scale=2.0)
    assert int(outs[0].telemetry.ingest_dropped) > 0


def test_cube_slab_overflow_counters():
    """Tiny slabs spill into the archive; only a saturated archive
    surfaces drops."""
    from loam_velodyne_tpu.parallel.replay import tiny_config
    base = tiny_config()
    m = dataclasses.replace(base.mapping, corner_cube_capacity=8,
                            surf_cube_capacity=8, insert_headroom=64,
                            archive_capacity=32, archive_append_budget=16,
                            archive_cubes_per_frame=1,
                            archive_reinstate_budget=16)
    outs = _step_engine(dataclasses.replace(base, mapping=m), 6, n_pts=512,
                        scale=3.0)
    assert sum(int(o.telemetry.mapping.cube_surf_dropped) for o in outs) > 0


def test_no_overflow_on_clean_run():
    from loam_velodyne_tpu.parallel.replay import tiny_config
    outs = _step_engine(tiny_config(), 2, n_pts=64, scale=2.0)
    for o in outs:
        assert int(o.telemetry.ingest_dropped) == 0
