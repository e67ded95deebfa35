"""Port parity, the per-sweep driver: loam_velodyne_torch.io.driver
(``LoamDriver``), the "auto" cadence of models.engine, registered_cloud,
the map exports and the archive compaction of models.mapping, and
utils.checkpoint, against the JAX package on the CPU.

Tolerances and why:
- Driver poses without an IMU: 1e-4 (observed maximum deviation:
  1.8e-7; the inputs are quantized to a 1/256 m grid, so ingest and
  features are bit-equal and only the GN solves round differently).
  With the rocking IMU stream of tests/test_oracle.py: 1e-3 (observed
  maximum deviation: 1.1e-4; the deskew rotates every point, so ingest
  is no longer bit-equal and near-equal curvatures can order
  differently, ROADMAP queue 3 "features").
- mapping_ran, surround_due and surround_count: exact. The telemetry
  counters and the archive cursor: exact without an IMU; with it, each
  counter to 2 and the cursor to 5% (observed: stack_surf_dropped off
  by 1 on two sweeps, the cursor by up to 6 of 357 rows), since the
  feature clouds that feed the map differ by a few points.
- registered_cloud from a JAX-reached state: mask exact, coordinates to
  1e-4 (observed maximum deviation: 1.1e-5 without IMU, 7.6e-6 with;
  map-frame coordinates of tens of metres).
- full_map: exact (a pure gather). surround_map: mask exact,
  coordinates to 1e-5 (observed maximum deviation: 0, the voxel sums
  run in one order). compact_archive: exact.
- export_tum: each number to 1e-5 (observed maximum deviation: 0).
- Checkpoints: bit-exact within the port and across the two packages;
  a JAX-written checkpoint resumed by the port continues as the JAX
  driver does to the driver's tolerances above (observed maximum
  deviation: 4.5e-8 without IMU, 9.4e-5 with).
- run_live against process_sweep and a resumed run against an
  uninterrupted one, both in the port: bit-equal.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loam_velodyne_tpu.io.driver import LoamDriver as JDriver
from loam_velodyne_tpu.io.imu import ImuTracker as JTracker
from loam_velodyne_tpu.models import engine as jeng
from loam_velodyne_tpu.models import mapping as jmap
from loam_velodyne_tpu.ops.scan import RawSweep as JRaw
from loam_velodyne_tpu.parallel.replay import tiny_config
from loam_velodyne_tpu.utils import checkpoint as jckpt
from loam_velodyne_tpu.utils import profiling as jprof
from loam_velodyne_torch.io.driver import LoamDriver as TDriver
from loam_velodyne_torch.models import engine as teng
from loam_velodyne_torch.models import mapping as tmap
from loam_velodyne_torch.utils import checkpoint as tckpt
from loam_velodyne_torch.utils import profiling as tprof
from loam_velodyne_torch.utils.convert import engine_state_from_numpy, to_numpy
from test_torch_engine import _port, _sweeps, slice_config
from test_torch_imu import trackers

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

N = 8
CKPT_AT = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_driver(cfg, imu, **kw):
    drv = TDriver(_port(cfg), device="cpu", system_delay=0, **kw)
    if imu:
        drv.imu_tracker = trackers(N)[1]
    return drv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX driver over N quantized sweeps, without and with the IMU
    stream: its per-sweep outputs, a checkpoint after CKPT_AT sweeps, its
    final state, and the port driver's run on the same input (without a
    tracker for the run without IMU). Both JAX runs share one compiled
    IMU step: the run without IMU has an empty tracker, whose empty
    windows leave the points, the odometry and the mapping pose exactly
    as without a window (the JAX package selects them with ``where`` on
    the window's count)."""
    cfg = slice_config()
    xyz, mask, _ = _sweeps(cfg, N)
    sweeps = [xyz[i][mask[i]] for i in range(N)]
    stamps = [0.1 * k for k in range(N)]
    out = {"cfg": cfg, "sweeps": sweeps, "stamps": stamps}
    step = None
    for imu in (False, True):
        jd = JDriver(cfg, system_delay=0)
        jd.imu_tracker = trackers(N)[0] if imu else JTracker()
        jd._step_imu = step or jd._step_imu
        step = jd._step_imu
        ckpt = str(tmp_path_factory.mktemp("jax") / "state.npz")
        outs_j = []
        for k, (pts, s) in enumerate(zip(sweeps, stamps)):
            outs_j.append(jd.process_sweep(pts, s))
            if k + 1 == CKPT_AT:
                jd.save_checkpoint(ckpt)
        td = _port_driver(cfg, imu)
        outs_t = [td.process_sweep(pts, s if imu else None)
                  for pts, s in zip(sweeps, stamps)]
        out[imu] = SimpleNamespace(jd=jd, outs_j=outs_j, ckpt=ckpt, td=td,
                                   outs_t=outs_t,
                                   state_j=jax.device_get(jd.state))
    return out


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_driver_matches_jax(runs, imu):
    r = runs[imu]
    tol = 1e-3 if imu else 1e-4
    for name in ("trajectory", "odom_trajectory", "mapped_trajectory"):
        np.testing.assert_allclose(np.stack(getattr(r.td, name)),
                                   np.stack(getattr(r.jd, name)), rtol=0, atol=tol,
                                   err_msg=name)
    ran_j = [bool(o.mapping_ran) for o in r.outs_j]
    assert [o.mapping_ran for o in r.outs_t] == ran_j == [k % 2 == 1 for k in range(N)]
    assert r.td.mapping_ran == ran_j
    assert [o.surround_due for o in r.outs_t] == [bool(o.surround_due) for o in r.outs_j]
    got = np.stack([o.packed for o in r.outs_t])
    want = np.stack([np.asarray(o.packed) for o in r.outs_j])
    np.testing.assert_array_equal(got[:, 18:20], want[:, 18:20])
    assert r.td.surround_count == r.jd.surround_count == 1
    if imu:
        np.testing.assert_allclose(got[:, 20:28], want[:, 20:28], rtol=0, atol=2)
        np.testing.assert_allclose(got[:, 28], want[:, 28], rtol=0.05)
    else:
        np.testing.assert_array_equal(got[:, 20:], want[:, 20:])
        assert dict(r.td.metrics.counters) == dict(r.jd.metrics.counters)
    assert r.td.metrics.summary()["timings"]["step"]["n"] == N
    assert np.abs(np.stack(r.jd.trajectory)[-1, 3:]).max() > 0.1   # it moved


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_registered_cloud_matches_jax(runs, imu):
    """From the JAX driver's final state, carried by utils/convert."""
    r = runs[imu]
    pts, stamp = runs["sweeps"][-1], runs["stamps"][-1] if imu else None
    want_xyz, want_mask = r.jd.registered_cloud(pts, stamp)
    drv = _port_driver(runs["cfg"], imu)
    drv.engine.load_state(engine_state_from_numpy(r.state_j, "cpu"))
    got_xyz, got_mask = drv.registered_cloud(pts, stamp)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got_xyz, want_xyz, rtol=0, atol=1e-4)
    assert want_mask.sum() > 1000


def test_map_exports_match_jax(runs):
    """full_map and surround_map of the JAX driver's final state."""
    r, cfg = runs[True], runs["cfg"]
    ms_j = jax.tree_util.tree_map(jnp.asarray, r.state_j.mapping)
    ms_t = engine_state_from_numpy(r.state_j, "cpu").mapping
    for got, want in zip(tmap.full_map(ms_t, _port(cfg)), jmap.full_map(ms_j, cfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(lambda m: jmap.surround_map(m, cfg))(ms_j)
    got = tmap.surround_map(ms_t, _port(cfg))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=1e-5)
    assert int(want.mask.sum()) > 100


def _pool(seed=5, a=4096):
    """An archive pool with duplicate cells, rows invalidated by
    recentering, both kinds and rows past the cursor."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(a // 4, 3)).astype(np.float32) * 20
    xyz = base[rng.integers(0, len(base), a)] + rng.normal(size=(a, 3)).astype(
        np.float32) * 0.01
    kind = rng.integers(0, 2, a).astype(np.int32)
    valid = rng.random(a) < 0.8
    return xyz.astype(np.float32), kind, valid, np.int32(a - 300)


@pytest.mark.parametrize("source", ["synthetic", "jax_state"])
def test_compact_archive_matches_jax(runs, source):
    cfg = runs["cfg"]
    if source == "synthetic":
        pool = _pool()
    else:
        ms = runs[True].state_j.mapping
        pool = (ms.archive_xyz, ms.archive_kind, ms.archive_valid, ms.archive_cnt)
    want = jax.jit(lambda p: jmap.compact_archive(p, cfg.mapping))(
        tuple(map(jnp.asarray, pool)))
    got = tmap.compact_archive(tuple(map(_t, pool)), _port(cfg).mapping)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if source == "synthetic":
        assert 0 < int(want[3]) < int(np.sum(pool[2][:pool[3]]))   # duplicates went


def test_driver_compacts_the_archive_past_three_quarters(runs, monkeypatch):
    """With a pool that the sequence fills past 3/4, the driver compacts
    it from the cursor in the packed rows, as JAX's compact_archive does
    on the same pool, and the run goes on from the compacted pool."""
    base = runs["cfg"]
    cfg = dataclasses.replace(base, mapping=dataclasses.replace(
        base.mapping, archive_capacity=640))
    calls = []
    compact = tmap.compact_archive
    monkeypatch.setattr(tmap, "compact_archive",
                        lambda pool, m: calls.append((pool, compact(pool, m)))
                        or calls[-1][1])
    drv = _port_driver(cfg, False)
    drv._compact_check_every = 1
    for pts in runs["sweeps"]:
        drv.process_sweep(pts)
    assert drv.metrics.counters["archive_compactions"] == len(calls) >= 1
    pool, got = calls[0]
    assert int(pool[3]) > 3 * 640 // 4
    want = jax.jit(lambda p: jmap.compact_archive(p, cfg.mapping))(
        tuple(jnp.asarray(a.numpy()) for a in pool))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isfinite(np.stack(drv.trajectory)).all()


def _stub_jax_stages(monkeypatch):
    """Replace the JAX engine's stages with trivial ones, so that its
    cadence gate (the io_ratio / stack_frame_num logic, the cond and the
    counters) compiles in a moment."""
    def ingest(raw, lidar, reg, imu_window=None):
        return SimpleNamespace(dropped=jnp.zeros((), jnp.int32)), None

    def odometry(state, feats, cfg, imu=None, static_schedule=False):
        new = state._replace(initialized=jnp.ones((), bool), frame=state.frame + 1)
        return new, SimpleNamespace(transform_sum=state.transform_sum,
                                    corner_cloud=None, surf_cloud=None)

    def mapping(state, pose, corner, surf, cfg, imu_rpy=None, static_schedule=False):
        return (state._replace(map_frame=state.map_frame + 1),
                jmap.MappingOutputs(pose, pose, state.map_frame % 3 == 0,
                                    jmap.MapTelemetry.zero()))

    monkeypatch.setattr(jeng, "scan_mod", SimpleNamespace(ingest_sweep=ingest))
    monkeypatch.setattr(jeng, "extract_features", lambda *a: ingest(None, None, None)[0])
    monkeypatch.setattr(jeng, "odometry_mod", SimpleNamespace(step=odometry))
    monkeypatch.setattr(jeng, "mapping_mod", SimpleNamespace(
        step=mapping, MapTelemetry=jmap.MapTelemetry))


@pytest.mark.parametrize("io_ratio,stack", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_auto_cadence_matches_jax(monkeypatch, io_ratio, stack):
    """mapping_ran and the carried counters of step(mapping_mode="auto")
    against the JAX package's gate, sweep by sweep."""
    base = tiny_config()
    cfg = dataclasses.replace(
        base, odometry=dataclasses.replace(base.odometry, io_ratio=io_ratio),
        mapping=dataclasses.replace(base.mapping, stack_frame_num=stack))
    engine = teng.Engine(_port(cfg), "cpu")
    rng = np.random.default_rng(0)
    sweeps = [rng.uniform(-4, 4, (192, 3)).astype(np.float32) for _ in range(8)]
    ran_t = [bool(engine.step(_t(p), torch.ones(192, dtype=torch.bool)).mapping_ran)
             for p in sweeps]
    state, ran_j = jeng.EngineState.create(cfg), []
    _stub_jax_stages(monkeypatch)
    step = jax.jit(lambda s, r: jeng.step(s, r, cfg))
    for p in sweeps:
        state, o = step(state, JRaw(jnp.asarray(p), jnp.ones((192,), bool)))
        ran_j.append(bool(o.mapping_ran))
    assert ran_t == ran_j and any(ran_j)
    assert engine.cadence == teng.Cadence(int(state.sweep), int(state.mapping_inputs),
                                          True)
    assert teng.Cadence.of(engine.state) == engine.cadence


def test_run_live_equals_process_sweep(runs):
    """The pipelined live loop (IMU on) gives the per-sweep path's
    trajectory and telemetry exactly."""
    r = runs[True]
    drv = _port_driver(runs["cfg"], True)
    lat = drv.run_live(runs["sweeps"], runs["stamps"])
    assert len(lat) == len(drv.live_events) == N
    for name in ("trajectory", "odom_trajectory", "mapped_trajectory"):
        assert np.array_equal(np.stack(getattr(drv, name)),
                              np.stack(getattr(r.td, name))), name
    assert dict(drv.metrics.counters) == dict(r.td.metrics.counters)
    assert drv.surround_count == r.td.surround_count
    assert set(drv.live_events[0]) >= {"dispatch_ms", "stage_ms", "consume_ms",
                                       "surround", "compact"}


def test_system_delay_drops_sweeps(runs):
    drv = TDriver(_port(runs["cfg"]), device="cpu", system_delay=2)
    sweeps = runs["sweeps"]
    assert drv.process_sweep(sweeps[0]) is None
    assert drv.process_sweep(sweeps[1]) is None
    assert drv.process_sweep(sweeps[2]) is not None
    assert len(drv.trajectory) == 1 and drv.engine.cadence.sweep == 1
    with pytest.raises(RuntimeError):
        TDriver(_port(runs["cfg"]), device="cpu", system_delay=1).run_chunked(sweeps)


def test_run_chunked_with_stamps_matches_process_sweep(runs):
    drv = _port_driver(runs["cfg"], True)
    drv.run_chunked(runs["sweeps"], chunk=3, stamps=runs["stamps"])
    assert np.array_equal(np.stack(drv.trajectory), np.stack(runs[True].td.trajectory))
    assert dict(drv.metrics.counters) == dict(runs[True].td.metrics.counters)


def test_export_tum_matches_jax(runs, tmp_path):
    r = runs[True]
    jd = JDriver(runs["cfg"], system_delay=0)
    jd.trajectory = list(r.td.trajectory)
    jd.export_tum(str(tmp_path / "jax.tum"))
    r.td.export_tum(str(tmp_path / "port.tum"))
    want = np.loadtxt(tmp_path / "jax.tum")
    got = np.loadtxt(tmp_path / "port.tum")
    assert got.shape == want.shape == (N, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _paths(tree, prefix=""):
    """Dotted field names of a NamedTuple tree's leaves, depth first."""
    if isinstance(tree, tuple):
        return [p for name, sub in zip(tree._fields, tree)
                for p in _paths(sub, f"{prefix}{name}.")]
    return [prefix[:-1]]


def test_checkpoint_leaf_order_matches_jax(runs):
    """The port's tree walk visits the state's fields in the order
    jax.tree_util.tree_flatten gives the JAX EngineState."""
    paths_j = [jax.tree_util.keystr(p, simple=True, separator=".")
               for p, _ in jax.tree_util.tree_flatten_with_path(runs[False].state_j)[0]]
    state_t = runs[False].td.engine.state
    assert _paths(state_t) == paths_j
    assert len(tckpt.tree_leaves(state_t)) == len(paths_j)
    for a, b in zip(tckpt.tree_leaves(to_numpy(state_t)),
                    jax.tree_util.tree_leaves(runs[False].state_j)):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype


def test_checkpoint_round_trip_is_bitexact(runs, tmp_path):
    td = runs[True].td
    path = str(tmp_path / "port.npz")
    td.save_checkpoint(path)
    drv = _port_driver(runs["cfg"], True)
    drv.load_checkpoint(path)
    for a, b in zip(tckpt.tree_leaves(drv.engine.state),
                    tckpt.tree_leaves(td.engine.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert drv.engine.cadence == td.engine.cadence == teng.Cadence(N, N // 2, True)


def test_resume_mid_sequence_is_bitexact(runs, tmp_path):
    """Auto-checkpoint after CKPT_AT sweeps, a "crash", and a new driver
    that resumes and finishes: the uninterrupted run's poses, bit for bit."""
    path = str(tmp_path / "auto.npz")
    drv = _port_driver(runs["cfg"], True, checkpoint_path=path,
                       checkpoint_every=CKPT_AT)
    for pts, s in zip(runs["sweeps"][:CKPT_AT + 1], runs["stamps"]):
        drv.process_sweep(pts, s)
    del drv
    drv = _port_driver(runs["cfg"], True, checkpoint_path=path)
    assert drv.resume() and drv.resumed_sweeps == CKPT_AT
    for pts, s in zip(runs["sweeps"][CKPT_AT:], runs["stamps"][CKPT_AT:]):
        drv.process_sweep(pts, s)
    assert np.array_equal(np.stack(drv.trajectory),
                          np.stack(runs[True].td.trajectory[CKPT_AT:]))


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_jax_checkpoint_resumes_in_port(runs, imu):
    """A checkpoint the JAX driver wrote after CKPT_AT sweeps, resumed by
    the port, continues as the JAX driver did."""
    r = runs[imu]
    drv = _port_driver(runs["cfg"], imu)
    drv.load_checkpoint(r.ckpt)
    assert drv.engine.cadence == teng.Cadence(CKPT_AT, CKPT_AT // 2, True)
    for pts, s in zip(runs["sweeps"][CKPT_AT:], runs["stamps"][CKPT_AT:]):
        drv.process_sweep(pts, s if imu else None)
    np.testing.assert_allclose(np.stack(drv.trajectory),
                               np.stack(r.jd.trajectory[CKPT_AT:]), rtol=0,
                               atol=1e-3 if imu else 1e-4)


def test_port_checkpoint_loads_in_jax(runs, tmp_path):
    td = runs[True].td
    path = str(tmp_path / "port.npz")
    td.save_checkpoint(path)
    loaded = jckpt.load_pytree(path, jeng.EngineState.create(runs["cfg"]))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    tckpt.tree_leaves(to_numpy(td.engine.state))):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_entry_points_run_on_the_card_unless_asked():
    cfg = _port(tiny_config())
    if torch.cuda.is_available():
        assert teng.Engine(cfg).device.type == "cuda"
        return
    for make in (lambda: teng.Engine(cfg), lambda: teng.EngineState.create(cfg),
                 lambda: TDriver(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert teng.Engine(cfg, "cpu").device.type == "cpu"


def test_metrics_match_jax(tmp_path):
    got, want = tprof.Metrics(), jprof.Metrics()
    for m in (got, want):
        for k in range(7):
            m.record("step", 0.01 * (k % 3 + 1))
            m.count("surround_maps", k % 2)
    assert got.summary() == want.summary()
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.mark.slow
def test_jax_driver_imu_ate_on_the_smoke_input(capsys):
    """The JAX package's trajectory error, on the CPU, on the input of
    chip_smoke.py's live IMU phase: the first 24 bench sweeps (VLP-16
    preset) with chip_smoke's rocking IMU stream, through
    process_sweep. It prints the ATE (the number PERF.md sets beside the
    port's on the card) and holds it to the same 15 cm gate. ~2.5 GB,
    several minutes."""
    import chip_smoke
    from loam_velodyne_tpu.config import LoamConfig
    from loam_velodyne_tpu.eval.metrics import ate_rmse
    from loam_velodyne_tpu.io.imu import ImuTracker

    cfg = LoamConfig.preset("VLP-16")
    n = chip_smoke.LIVE_SWEEPS
    xyz, mask, gt = chip_smoke.synthetic.bench_sequence(n, cfg.lidar,
                                                        chip_smoke.SWEEP_CAP)
    drv = JDriver(cfg, sweep_capacity=chip_smoke.SWEEP_CAP, system_delay=0)
    drv.imu_tracker = ImuTracker(cfg.registration.imu_history_size)
    for t, rpy, acc in chip_smoke.synthetic.imu_stream(n):
        drv.imu_tracker.push_state(t, rpy, acc)
    for k in range(n):
        drv.process_sweep(xyz[k][mask[k]], 0.1 * k)
    ate = ate_rmse(drv.positions(), gt, align=True)
    with capsys.disabled():
        print(f"\nJAX package on the CPU, chip_smoke's live IMU input ({n} "
              f"sweeps): ATE {ate * 100:.3f} cm; telemetry "
              f"{dict(drv.metrics.counters)}")
    assert ate <= chip_smoke.IMU_ATE_GATE_M
