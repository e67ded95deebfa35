"""Port parity, the batched replay: loam_velodyne_torch.parallel.replay
(B lanes of one op stream, ``torch.func.vmap`` over ``run_chunk``;
the batched per-sweep step at mixed starts is
tests/test_torch_batched_step.py's) against the JAX package's ``make_batched_chunk`` (``jax.vmap``) and
against the port's own single-stream ``run_chunk``, on the CPU.

Every vmapped call runs with the vmap fallback off (``replay``
switches it off) and with the fallback's performance warning turned
into an error: an operation without a batching rule fails the test
instead of running lane by lane.

Tolerances and why:
- Against JAX, lane by lane, two distinct lanes: poses to 1e-4 without
  the IMU (the single-stream parity of test_torch_engine, observed
  maximum deviation: 1.4e-7), 1e-3 with the rocking IMU stream (that of
  test_torch_driver; observed: 1.5e-4). Flags exact; telemetry counters
  and the archive cursor exact without the IMU, with it each counter to
  2 and the cursor to 5% (test_torch_driver's IMU tolerances).
- Against the port's single stream: poses to 1e-6 (observed maximum
  deviation: 8.9e-8; the batched Gauss-Newton solves and eigh round
  differently from one system at a time), flags, counters and cursor
  exact.
- Lane forms against their plain twins, lane by lane on the CPU: exact,
  integers and floats alike (the same plain operations per lane; the
  lane segment sums keep each segment's row order).
- Determinism: two batched runs are bit-equal.

The JAX side is committed, not compiled in tier-1: ``tests/replay_jax.npz``
holds the JAX ``make_batched_chunk``'s packed outputs, (B, K, 29),
without and with the IMU, and a SHA-256 of the input sweeps and windows
that wrote them (the tests refuse a file whose hash does not match the
inputs built here). It is written by

    python tests/test_torch_replay.py regen

(JAX on the CPU, a few minutes); the slow
``test_committed_jax_reference_is_live`` recomputes it and holds the
file to it within 1e-6 (the JAX CPU build may round otherwise than the
build that wrote it).
"""

import contextlib
import dataclasses
import hashlib
import os
import sys
import warnings

import numpy as np
import pytest
import torch

if __name__ == "__main__":            # python tests/test_torch_replay.py regen
    sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from loam_velodyne_tpu.io import synthetic  # noqa: E402
from loam_velodyne_tpu.models import engine as jeng  # noqa: E402
from loam_velodyne_tpu.ops.imu import ImuWindow as JWindow  # noqa: E402
from loam_velodyne_tpu.ops.scan import RawSweep as JRaw  # noqa: E402
from loam_velodyne_tpu.parallel import replay as jreplay  # noqa: E402
from loam_velodyne_torch.models import engine as teng  # noqa: E402
from loam_velodyne_torch.ops import (corresp_kernel, greedy_kernel,  # noqa: E402
                                     grid_kernel, knn_kernel, voxel)
from loam_velodyne_torch.ops.imu import ImuWindow as TWindow  # noqa: E402
from loam_velodyne_torch.ops.scan import RawSweep as TRaw  # noqa: E402
from loam_velodyne_torch.parallel import replay as treplay  # noqa: E402
from test_torch_engine import _port, slice_config  # noqa: E402
from test_torch_imu import trackers  # noqa: E402

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

B, K = 2, 8
SPEEDS = (1.0, 0.6)
GAINS = (1.0, 0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lane_sweeps(cfg, speed, n_azimuth=600, quantum=256):
    """K quantized sweeps of the turning trajectory at ``speed``
    (test_torch_engine's input at speed 1)."""
    sweeps, gt, _ = synthetic.generate_sequence(
        K, lidar=cfg.lidar, n_azimuth=n_azimuth, noise_std=0.005,
        traj=synthetic.turning_trajectory(speed=speed))
    cap = cfg.lidar.n_rings * n_azimuth
    xyz = np.zeros((K, cap, 3), np.float32)
    mask = np.zeros((K, cap), bool)
    for i, pts in enumerate(sweeps):
        pts = np.round(pts * quantum) / quantum
        xyz[i, :len(pts)], mask[i, :len(pts)] = pts, True
    return xyz, mask, gt


def _windows():
    """Per lane, K IMU windows from the rocking stream at that lane's
    gain: JAX's and the port's, as numpy, stacked (B, K, ...)."""
    per_lane = []
    for gain in GAINS:
        tj, tt = trackers(K, gain)
        jw = [tj.window_for_sweep(0.1 * k) for k in range(K)]
        tw = [tt.window_for_sweep(0.1 * k, device="cpu") for k in range(K)]
        per_lane.append(([np.stack([np.asarray(w[f]) for w in jw]) for f in range(5)],
                         [np.stack([w[f].numpy() for w in tw]) for f in range(5)]))
    jwin = [np.stack([lane[0][f] for lane in per_lane]) for f in range(5)]
    twin = [np.stack([lane[1][f] for lane in per_lane]) for f in range(5)]
    return jwin, twin


@pytest.fixture(scope="module")
def inputs():
    cfg = slice_config()
    lanes = [_lane_sweeps(cfg, s) for s in SPEEDS]
    xyz = np.stack([a[0] for a in lanes])
    mask = np.stack([a[1] for a in lanes])
    return cfg, xyz, mask


@contextlib.contextmanager
def no_fallback_warnings():
    """The vmap fallback's performance warning as an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*fallback.*")
        warnings.filterwarnings("error", message=".*[Pp]erformance drop.*")
        yield


def _port_batched(cfg, xyz, mask, twin=None):
    pc = _port(cfg)
    chunk = treplay.make_batched_chunk(pc, with_imu=twin is not None)
    wins = None if twin is None else TWindow(*map(_t, twin))
    with no_fallback_warnings():
        return chunk(treplay.create_states(pc, B, "cpu"),
                     TRaw(_t(xyz), _t(mask)), imu_windows=wins)


REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "replay_jax.npz")


def input_hash(xyz, mask, jwin) -> str:
    """SHA-256 of the input sweeps and the JAX windows (dtype, shape and
    bytes of each array, in order)."""
    h = hashlib.sha256()
    for a in (xyz, mask, *jwin):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def jax_packed(cfg, xyz, mask, jwin, imu: bool) -> np.ndarray:
    """The JAX batched chunk's packed outputs (B, K, 29) from fresh states."""
    run = jreplay.make_batched_chunk(cfg, donate=False, with_imu=imu)
    states = jreplay.stack_states([jeng.EngineState.create(cfg)
                                   for _ in range(B)])
    args = (states, JRaw(jnp.asarray(xyz), jnp.asarray(mask)))
    if imu:
        args += (JWindow(*map(jnp.asarray, jwin)),)
    _, outs = run(*args)
    return np.asarray(jax.device_get(outs.packed))


def committed_reference(xyz, mask, jwin) -> dict:
    """The committed JAX outputs by ``imu``; refuses a file written from
    other inputs."""
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    got = input_hash(xyz, mask, jwin)
    if str(ref["input_sha256"]) != got:
        raise AssertionError(
            f"{REFERENCE} was written from other inputs (sha256 "
            f"{ref['input_sha256']}, inputs now {got}): run "
            f"python tests/test_torch_replay.py regen")
    return {False: ref["packed_no_imu"], True: ref["packed_imu"]}


@pytest.fixture(scope="module")
def runs(inputs):
    """The JAX batched chunk's packed outputs (committed) and the port's
    run (live), without and with the IMU."""
    cfg, xyz, mask = inputs
    jwin, twin = _windows()
    ref = committed_reference(xyz, mask, jwin)
    out = {}
    for imu in (False, True):
        state_t, outs_t = _port_batched(cfg, xyz, mask, twin if imu else None)
        out[imu] = (ref[imu], outs_t, state_t)
    return out


@pytest.mark.slow
def test_committed_jax_reference_is_live(inputs):
    """The JAX batched chunk recomputed on this build equals the
    committed file within 1e-6."""
    cfg, xyz, mask = inputs
    jwin = _windows()[0]
    ref = committed_reference(xyz, mask, jwin)
    for imu in (False, True):
        got = jax_packed(cfg, xyz, mask, jwin, imu)
        assert got.shape == ref[imu].shape == (B, K, 29)
        np.testing.assert_allclose(got, ref[imu], rtol=0, atol=1e-6,
                                   err_msg=f"imu={imu}")


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_batched_chunk_matches_jax_lane_by_lane(runs, imu):
    pj, outs_t, _ = runs[imu]
    pt = outs_t.packed.numpy()
    assert pt.shape == pj.shape == (B, K, 29)
    tol = 1e-3 if imu else 1e-4
    for i in range(B):
        np.testing.assert_allclose(pt[i, :, :18], pj[i, :, :18], rtol=0,
                                   atol=tol, err_msg=f"lane {i}")
        np.testing.assert_array_equal(pt[i, :, 18:20], pj[i, :, 18:20])
        if imu:
            assert np.abs(pt[i, :, 20:28] - pj[i, :, 20:28]).max() <= 2
            np.testing.assert_allclose(pt[i, :, 28], pj[i, :, 28], rtol=0.05)
        else:
            np.testing.assert_array_equal(pt[i, :, 20:], pj[i, :, 20:])
    # Distinct lanes, and the map and its telemetry exercised.
    assert np.abs(pj[0, :, :18] - pj[1, :, :18]).max() > 1e-2
    assert pj[:, :, 20:28].sum() > 0
    np.testing.assert_array_equal(pt[:, :, 18], np.tile(np.arange(K) % 2, (B, 1)))


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_batched_chunk_matches_the_port_single_stream(runs, inputs, imu):
    cfg, xyz, mask = inputs
    pc = _port(cfg)
    _, outs_t, state_t = runs[imu]
    twin = _windows()[1] if imu else None
    for i in range(B):
        wins = None if twin is None else TWindow(*(_t(a[i]) for a in twin))
        state_1, outs_1 = teng.run_chunk(teng.EngineState.create(pc, "cpu"),
                                         TRaw(_t(xyz[i]), _t(mask[i])), pc,
                                         imu_windows=wins)
        lane = treplay.lane(outs_t, i)
        np.testing.assert_allclose(lane.packed[:, :18].numpy(),
                                   outs_1.packed[:, :18].numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"lane {i}")
        assert torch.equal(lane.packed[:, 18:], outs_1.packed[:, 18:])
        lane_state = treplay.lane(state_t, i)
        for name in ("corner_cnt", "surf_cnt", "origin", "archive_cnt",
                     "archive_cursor", "archive_valid"):
            assert torch.equal(getattr(lane_state.mapping, name),
                               getattr(state_1.mapping, name)), name
        assert torch.equal(lane_state.sweep, state_1.sweep)


def test_batched_chunk_is_deterministic(inputs, runs):
    """Mirrors tests/test_replay.py::test_engine_is_deterministic: a
    functional engine gives bit-identical reruns."""
    cfg, xyz, mask = inputs
    _, outs_t, state_t = runs[False]
    state_2, outs_2 = _port_batched(cfg, xyz, mask)
    assert torch.equal(outs_t.packed, outs_2.packed)
    for a, b in zip(state_t.odometry, state_2.odometry):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_two_chunks_continue_from_the_host_cadence(inputs, runs):
    """Two chunks of K/2 with the lanes' cadence read from the states
    (and the second from the host's cadence) give the one chunk of K."""
    cfg, xyz, mask = inputs
    pc = _port(cfg)
    chunk = treplay.make_batched_chunk(pc)
    states = treplay.create_states(pc, B, "cpu")
    h = K // 2
    with no_fallback_warnings():
        states, a = chunk(states, TRaw(_t(xyz[:, :h]), _t(mask[:, :h])))
        assert treplay.lanes_cadence(states) == teng.Cadence(h, h // 2, True)
        _, b = chunk(states, TRaw(_t(xyz[:, h:]), _t(mask[:, h:])),
                     teng.Cadence(h, h // 2, True))
    assert torch.equal(torch.cat([a.packed, b.packed], 1), runs[False][1].packed)


def test_batched_step_matches_the_chunk(inputs, runs):
    """make_batched_step sweep by sweep (each lane's decisions taken on
    the device, both odometry branches and mapping on every lane, each
    lane keeping its own) gives the static batched chunk's outputs and
    state bit for bit over aligned lanes, and so does
    make_batched_chunk(static_cadence=False)."""
    cfg, xyz, mask = inputs
    pc = _port(cfg)
    step = treplay.make_batched_step(pc)
    states = treplay.create_states(pc, B, "cpu")
    rows = []
    with no_fallback_warnings():
        for k in range(K):
            states, o = step(states, TRaw(_t(xyz[:, k]), _t(mask[:, k])))
            rows.append(o.packed)
        chunk = treplay.make_batched_chunk(pc, static_cadence=False)
        states_c, outs_c = chunk(treplay.create_states(pc, B, "cpu"),
                                 TRaw(_t(xyz), _t(mask)))
    assert torch.equal(torch.stack(rows, 1), runs[False][1].packed)
    assert torch.equal(outs_c.packed, runs[False][1].packed)
    for got in (states, states_c):
        for a, b in zip(teng.graph_mod.leaves(got),
                        teng.graph_mod.leaves(runs[False][2])):
            assert torch.equal(a, b)


def test_replay_sequences_tiny():
    """replay_sequences on the port's tiny_config (the JAX package's
    tiny_config), 3 lanes of 3 random sweeps: fused positions (B, T, 3),
    finite, each lane its own."""
    cfg = treplay.tiny_config()
    rng = np.random.default_rng(0)
    seqs = [[rng.uniform(-5, 5, (200, 3)).astype(np.float32)
             for _ in range(3)] for _ in range(3)]
    pos = treplay.replay_sequences(cfg, seqs, device="cpu", sweep_capacity=256)
    assert pos.shape == (3, 3, 3) and np.isfinite(pos).all()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jreplay.tiny_config())


@pytest.mark.parametrize("case", ["unshared_starts", "off_the_boundary"])
def test_static_chunk_refuses_unaligned_lanes(inputs, case):
    """The static chunk schedules mapping on the host, so its lanes must
    share their start, on an io_ratio boundary (the batched step, and
    make_batched_chunk(static_cadence=False), take any starts)."""
    cfg = _port(inputs[0])
    a = teng.EngineState.create(cfg, "cpu")
    chunk = treplay.make_batched_chunk(cfg)
    raws = TRaw(torch.zeros((2, 2, 8, 3)), torch.zeros((2, 2, 8), dtype=torch.bool))
    if case == "unshared_starts":
        states = treplay.stack_states([a, a._replace(sweep=a.sweep + 2)])
        with pytest.raises(ValueError, match="share their start"):
            treplay.lanes_cadence(states)
        with pytest.raises(ValueError, match="share their start"):
            chunk(states, raws)
    else:
        with pytest.raises(ValueError, match="not aligned"):
            chunk(treplay.stack_states([a, a]), raws,
                  teng.Cadence(1, 0, True))


# Lane forms against their plain twins on the CPU, at small shapes, and
# the segment sums' lane form.
def _lane_cases():
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    b = 3
    cases = {}
    npad, p = 300, 64
    starts = rng.integers(-10, npad, size=(b, 5)).astype(np.int32)
    cases["grid"] = (grid_kernel.grid_windows_lanes,
                     grid_kernel.grid_windows_lanes_plain,
                     grid_kernel.grid_windows,
                     (t(rng.normal(size=(b, 4, npad)).astype(np.float32)),
                      t(starts), p))
    rows, w, k = 6, 96, 24
    curv = rng.exponential(0.1, size=(b, rows, w)).astype(np.float32)
    cand = np.argsort(-curv, axis=2, kind="stable")[..., :k].astype(np.int32)
    cases["greedy"] = (greedy_kernel.greedy_pick_rows_lanes,
                       greedy_kernel.greedy_pick_rows_lanes_plain,
                       greedy_kernel.greedy_pick_rows,
                       (t(curv), t(cand), t(rng.random((b, rows, k)) < 0.9),
                        t(rng.random((b, rows, w)) < 0.1),
                        t(rng.integers(0, 6, (b, rows, w)).astype(np.int32)),
                        t(rng.integers(0, 6, (b, rows, w)).astype(np.int32)),
                        0.1, 8, 2, True))
    nq, m = 40, 120
    cases["corresp"] = (corresp_kernel.corresp_search_lanes,
                        corresp_kernel.corresp_search_lanes_plain,
                        corresp_kernel.corresp_search,
                        (t((rng.normal(size=(b, nq, 3)) * 5).astype(np.float32)),
                         t((rng.normal(size=(b, m, 3)) * 5).astype(np.float32)),
                         t(rng.integers(0, 8, (b, m)).astype(np.int32)),
                         t(rng.random((b, m)) < 0.8), 2.5, True))
    tg, g, win = 2, 16, 64
    cases["knn"] = (knn_kernel.grouped_window_knn_lanes,
                    knn_kernel.grouped_window_knn_lanes_plain,
                    knn_kernel.grouped_window_knn,
                    (t(rng.normal(size=(b, tg, g, 3)).astype(np.float32)),
                     t(rng.normal(size=(b, tg, win, 3)).astype(np.float32)), 5))
    n, s = 50, 7
    lengths = np.stack([np.diff(np.concatenate(
        [[0], np.sort(rng.integers(0, n, s - 1)), [n]])) for _ in range(b)])
    cases["segment_sum"] = (voxel.segment_sum_lanes, voxel.segment_sum_lanes_plain,
                            voxel.segment_sum,
                            (t(rng.normal(size=(b, n, 5)).astype(np.float32)),
                             t(lengths.astype(np.int64))))
    return cases


LANE_CASES = _lane_cases()


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", list(LANE_CASES))
def test_lane_form_equals_its_plain_twin(name):
    """The lane form (its CPU path) and the plain twin equal the
    single-lane plain version applied lane by lane, exactly."""
    lanes_fn, twin, single, args = LANE_CASES[name]
    got, want = _tuple(lanes_fn(*args)), _tuple(twin(*args))
    for i in range(args[0].shape[0]):
        one = _tuple(single(*(a[i] if isinstance(a, torch.Tensor) else a
                              for a in args)))
        for g, w, o in zip(got, want, one):
            assert torch.equal(g[i], o) and torch.equal(w[i], o)


@pytest.mark.parametrize("name", list(LANE_CASES))
def test_vmapped_wrapper_reaches_the_lane_form(name, monkeypatch):
    """Under vmap the single-lane wrapper calls its lane form once (the
    custom op's vmap rule), with the fallback off, and gives the plain
    twin's outputs."""
    lanes_fn, twin, single, args = LANE_CASES[name]
    mod = {"grid": grid_kernel, "greedy": greedy_kernel,
           "corresp": corresp_kernel, "knn": knn_kernel,
           "segment_sum": voxel}[name]
    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return lanes_fn(*a)

    monkeypatch.setattr(mod.lane_op, "lanes", spy)
    dims = tuple(0 if isinstance(a, torch.Tensor) else None for a in args)
    with no_fallback_warnings(), treplay.no_vmap_fallback():
        got = _tuple(torch.func.vmap(single, in_dims=dims)(*args))
    assert calls == [args[0].shape]
    for g, w in zip(got, _tuple(twin(*args))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(LANE_CASES))
def test_single_lane_call_is_the_lane_form_at_one_lane(name, monkeypatch):
    """Outside vmap the wrapper runs the same lane form, at B = 1: one
    launch path per kernel."""
    lanes_fn, twin, single, args = LANE_CASES[name]
    mod = {"grid": grid_kernel, "greedy": greedy_kernel,
           "corresp": corresp_kernel, "knn": knn_kernel,
           "segment_sum": voxel}[name]
    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return lanes_fn(*a)

    monkeypatch.setattr(mod.lane_op, "lanes", spy)
    lane1 = tuple(a[1] if isinstance(a, torch.Tensor) else a for a in args)
    got = _tuple(single(*lane1))
    assert calls == [(1,) + args[0].shape[1:]]
    for g, w in zip(got, _tuple(twin(*args))):
        assert torch.equal(g, w[1])


def test_lane_split_rehearsal_on_the_cpu(inputs):
    """tools/lane_split.py at the slice shape on the CPU: the B = 1 chunk
    and the B-lane step from a common state track the single stream to
    rounding, the lanes are equal, both steps make the same traced calls,
    and no traced call's single-lane replay parts by more than rounding."""
    from loam_velodyne_torch.tools import lane_split
    cfg, xyz, mask = inputs
    pc, dev = _port(cfg), torch.device("cpu")
    x, m = _t(xyz[0]), _t(mask[0])
    with no_fallback_warnings():
        c1 = lane_split.chunk_at_one_lane(pc, dev, x, m)
        sp = lane_split.split_sweep(pc, dev, x, m, 3, 3)
    assert len(c1["max_dev_by_sweep"]) == K
    assert max(c1["max_dev_by_sweep"]) <= 1e-6
    assert sp["same_call_sequence"] and sp["calls"] > 0
    assert sp["lanes_equal_b3"] and sp["lanes_equal_b1"]
    assert sp["pose_dev_b1"] <= 1e-6 and sp["pose_dev_b3"] <= 1e-6
    calls = {e["call"] for e in sp["trace"]}
    assert {"features.greedy_pick_rows", "odometry.solve_gn", "mapping.step",
            "fit.plane_fit"} <= calls
    for e in sp["trace"]:
        assert e["replay"]["int"] == 0 and e["replay"]["float"] <= 1e-6, e


if __name__ == "__main__":
    if sys.argv[1:] != ["regen"]:
        raise SystemExit("usage: python tests/test_torch_replay.py regen")
    jax.config.update("jax_platforms", "cpu")
    cfg = slice_config()
    lanes = [_lane_sweeps(cfg, s) for s in SPEEDS]
    xyz = np.stack([a[0] for a in lanes])
    mask = np.stack([a[1] for a in lanes])
    jwin = _windows()[0]
    arrays = {f"packed_{'imu' if imu else 'no_imu'}":
              jax_packed(cfg, xyz, mask, jwin, imu) for imu in (False, True)}
    np.savez_compressed(REFERENCE, input_sha256=np.array(
        input_hash(xyz, mask, jwin)), **arrays)
    print(f"wrote {REFERENCE}: " + "; ".join(
        f"{k} {v.shape}, telemetry {v[:, :, 20:28].sum():.0f}"
        for k, v in arrays.items()))
