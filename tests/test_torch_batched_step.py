"""Port parity, the batched per-sweep step: ``parallel/replay.py``'s
``make_batched_step`` (vmap over ``engine.lane_step``, every decision
taken on the device from each lane's own counters) against the JAX
package's ``make_batched_step`` (``jax.jit(jax.vmap(engine.step))``,
``mapping_mode="auto"``, the dynamic schedules), on the CPU, at
``slice_config()`` shapes.

- **Mixed starts against JAX.** Three lanes of distinct sequences: one
  fresh, one after 1 sweep, one after 2 (each lane's prefix stepped by
  its own single stream, JAX's and the port's), then K batched sweeps,
  so in each sweep one lane takes its first-sweep branch or maps where
  another does not; without and with IMU windows.
- **The dynamic chunk against JAX.** ``make_batched_chunk(
  static_cadence=False)`` from starts 1, 3 and 2 (two of them off the
  io_ratio boundary), against the JAX one.
- **Against the port's single streams**, lane by lane.
- **The graphed composition.** ``batched_step_graphed`` through a
  stand-in for the capture (tests/test_torch_step_graph.py's
  ``EagerGraphs``, its conditional nodes through
  tests/test_torch_conditional.py's stand-in, which poisons what a
  skipped region made): bit-equal to the eager step at mixed starts,
  with one key for every mix of starts.
- **No host read** inside the vmapped step, eager or composed: a
  ``TorchDispatchMode`` that raises on ``aten._local_scalar_dense`` and
  the other reads of tests/test_torch_graph.py's ``HostReads``; a
  planted read of the "any lane due" flag is caught.

The aligned case (the step bit-equal to the static batched chunk) is
tests/test_torch_replay.py's ``test_batched_step_matches_the_chunk``.

Tolerances and why: against JAX, poses to 1e-4 without the IMU and
1e-3 with it (tests/test_torch_replay.py's stated tolerances; observed
without the IMU: equal, with it 4.9e-5). Without the IMU every other
column (flags, ``mapping_ran``, telemetry counters, the archive
cursor) and the lanes' counters after the run exactly. With the IMU
the flags (``mapping_ran``, ``surround_due``) and the lanes' cadence
counters (sweep, bundles forwarded, initialized, odometry and mapping
frames) exactly; each telemetry counter to 2 and the archive cursor
to 5% (test_torch_replay's IMU tolerances: observed 1 surfel of the
stack's drops and 3.3%, on the first mapping frame of the fresh lane),
and the archive's cursors after the run not compared: the counters
and cursors follow the deskewed clouds and the map, which the IMU
parity's rounding moves (the port's single stream parts from the JAX
one there alike; the batched step equals the port's single streams
exactly). Against the port's single streams,
poses to 1e-6 (test_torch_replay's batched-against-single tolerance),
the rest exactly. The graphed composition against eager: none.

The JAX side is committed, not compiled in tier-1:
``tests/batched_step_jax.npz`` holds the JAX runs' packed outputs
(B, K, 29) and the lanes' counters after them, with a SHA-256 of the
inputs (sweeps, windows, starts) that wrote them (the tests refuse a
file whose hash does not match the inputs built here). It is written by

    python tests/test_torch_batched_step.py regen

(JAX on the CPU, a few minutes); the slow
``test_committed_jax_reference_is_live`` recomputes it and holds the
file to it within 1e-6.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":        # python tests/test_torch_batched_step.py regen
    sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from loam_velodyne_tpu.models import engine as jeng  # noqa: E402
from loam_velodyne_tpu.ops.imu import ImuWindow as JWindow  # noqa: E402
from loam_velodyne_tpu.ops.scan import RawSweep as JRaw  # noqa: E402
from loam_velodyne_tpu.parallel import replay as jreplay  # noqa: E402
from loam_velodyne_torch.models import conditional  # noqa: E402
from loam_velodyne_torch.models import engine as teng  # noqa: E402
from loam_velodyne_torch.ops.imu import ImuWindow as TWindow  # noqa: E402
from loam_velodyne_torch.ops.scan import RawSweep as TRaw  # noqa: E402
from loam_velodyne_torch.parallel import replay as treplay  # noqa: E402
from test_torch_conditional import host_conditionals  # noqa: E402
from test_torch_engine import _port, slice_config  # noqa: E402
from test_torch_graph import HostReads  # noqa: E402
from test_torch_imu import trackers  # noqa: E402
from test_torch_replay import _lane_sweeps, no_fallback_warnings  # noqa: E402
from test_torch_step_graph import EagerGraphs  # noqa: E402

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

SPEEDS = (1.0, 0.6, 0.8)
GAINS = (1.0, 0.5, 0.75)
K = 4
STARTS = {"step": (0, 1, 2), "chunk": (1, 3, 2)}
CASES = (("step", False), ("step", True), ("chunk", False))
SEQ = 8                          # sweeps made for each lane (test_torch_replay's K)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case_name(kind, imu) -> str:
    return f"{kind}_{'imu' if imu else 'no_imu'}"


def _windows():
    """Per lane, SEQ IMU windows of the rocking stream at that lane's
    gain: JAX's and the port's, as numpy, stacked (B, SEQ, ...)."""
    jlanes, tlanes = [], []
    for gain in GAINS:
        tj, tt = trackers(SEQ, gain)
        jw = [tj.window_for_sweep(0.1 * k) for k in range(SEQ)]
        tw = [tt.window_for_sweep(0.1 * k, device="cpu") for k in range(SEQ)]
        jlanes.append([np.stack([np.asarray(w[f]) for w in jw]) for f in range(5)])
        tlanes.append([np.stack([w[f].numpy() for w in tw]) for f in range(5)])
    return ([np.stack([lane[f] for lane in jlanes]) for f in range(5)],
            [np.stack([lane[f] for lane in tlanes]) for f in range(5)])


def make_inputs():
    cfg = slice_config()
    lanes = [_lane_sweeps(cfg, s) for s in SPEEDS]
    xyz = np.stack([a[0] for a in lanes])
    mask = np.stack([a[1] for a in lanes])
    jwin, twin = _windows()
    return cfg, xyz, mask, jwin, twin


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def input_hash(xyz, mask, jwin) -> str:
    """SHA-256 of the input sweeps, the JAX windows and the starts."""
    h = hashlib.sha256()
    starts = np.array([STARTS["step"], STARTS["chunk"]], np.int32)
    for a in (xyz, mask, *jwin, starts, np.array([K], np.int32)):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _batched_at(a, starts, k):
    """Sweep (start + k) of each lane of (B, SEQ, ...) arrays."""
    return np.stack([a[i, s + k] for i, s in enumerate(starts)])


def _chunk_of(a, starts):
    """K sweeps from each lane's start: (B, K, ...)."""
    return np.stack([a[i, s:s + K] for i, s in enumerate(starts)])


# -- JAX --------------------------------------------------------------------

def _jax_counters(states) -> np.ndarray:
    return np.stack([np.asarray(x).astype(np.int64) for x in (
        states.sweep, states.mapping_inputs, states.odometry.initialized,
        states.odometry.frame, states.mapping.map_frame,
        states.mapping.archive_cnt, states.mapping.archive_cursor)], 1)


def jax_case(cfg, xyz, mask, jwin, kind: str, imu: bool):
    """The JAX run of a case: (packed (B, K, 29), counters (B, 7))."""
    starts = STARTS[kind]
    if imu:
        one = jax.jit(lambda s, r, w: jeng.step(s, r, cfg, w))
    else:
        one = jax.jit(lambda s, r: jeng.step(s, r, cfg))
    states = []
    for i, s0 in enumerate(starts):
        state = jeng.EngineState.create(cfg)
        for j in range(s0):
            args = (state, JRaw(jnp.asarray(xyz[i, j]), jnp.asarray(mask[i, j])))
            if imu:
                args += (JWindow(*(jnp.asarray(w[i, j]) for w in jwin)),)
            state, _ = one(*args)
        states.append(state)
    states = jreplay.stack_states(states)
    if kind == "chunk":
        run = jreplay.make_batched_chunk(cfg, donate=False, with_imu=imu,
                                         static_cadence=False)
        args = (states, JRaw(jnp.asarray(_chunk_of(xyz, starts)),
                             jnp.asarray(_chunk_of(mask, starts))))
        if imu:
            args += (JWindow(*(jnp.asarray(_chunk_of(w, starts)) for w in jwin)),)
        states, outs = run(*args)
        packed = np.asarray(outs.packed)
    else:
        step = jreplay.make_batched_step(cfg, donate=False, with_imu=imu)
        rows = []
        for k in range(K):
            args = (states, JRaw(jnp.asarray(_batched_at(xyz, starts, k)),
                                 jnp.asarray(_batched_at(mask, starts, k))))
            if imu:
                args += (JWindow(*(jnp.asarray(_batched_at(w, starts, k))
                                   for w in jwin)),)
            states, outs = step(*args)
            rows.append(np.asarray(outs.packed))
        packed = np.stack(rows, 1)
    return packed, _jax_counters(states)


REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "batched_step_jax.npz")


def committed_reference(xyz, mask, jwin) -> dict:
    """The committed JAX runs by case name; refuses a file written from
    other inputs."""
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    got = input_hash(xyz, mask, jwin)
    if str(ref["input_sha256"]) != got:
        raise AssertionError(
            f"{REFERENCE} was written from other inputs (sha256 "
            f"{ref['input_sha256']}, inputs now {got}): run "
            f"python tests/test_torch_batched_step.py regen")
    return {_case_name(kind, imu): (ref[f"packed_{_case_name(kind, imu)}"],
                                    ref[f"counters_{_case_name(kind, imu)}"])
            for kind, imu in CASES}


# -- The port ---------------------------------------------------------------

def port_counters(states) -> np.ndarray:
    return torch.stack([x.to(torch.int64) for x in (
        states.sweep, states.mapping_inputs, states.odometry.initialized,
        states.odometry.frame, states.mapping.map_frame,
        states.mapping.archive_cnt, states.mapping.archive_cursor)], 1).numpy()


def _twin(twin, i, j):
    return TWindow(*(_t(w[i, j]) for w in twin))


def port_start_states(pc, xyz, mask, twin, starts):
    """Each lane's state after its prefix, stepped by the port's single
    stream (the eager dynamic step), stacked."""
    states = []
    for i, s0 in enumerate(starts):
        state, cadence = teng.EngineState.create(pc, "cpu"), teng.Cadence()
        for j in range(s0):
            state, _ = teng.step(state, TRaw(_t(xyz[i, j]), _t(mask[i, j])), pc,
                                 "auto", cadence,
                                 None if twin is None else _twin(twin, i, j))
            cadence = cadence.advance(pc)
        states.append(state)
    return treplay.stack_states(states)


def sweep_at(xyz, mask, twin, starts, k):
    raw = TRaw(_t(_batched_at(xyz, starts, k)), _t(_batched_at(mask, starts, k)))
    win = None if twin is None else TWindow(
        *(_t(_batched_at(w, starts, k)) for w in twin))
    return raw, win


def port_steps(step, states, xyz, mask, twin, starts):
    """K sweeps of a batched ``step(states, raw, win)``: (states, packed
    (B, K, 29))."""
    rows = []
    with no_fallback_warnings():
        for k in range(K):
            raw, win = sweep_at(xyz, mask, twin, starts, k)
            states, outs = step(states, raw, win)
            rows.append(outs.packed)
    return states, torch.stack(rows, 1)


@pytest.fixture(scope="module")
def runs(inputs):
    """By case: the committed JAX run and the port's (its final states
    and packed rows)."""
    cfg, xyz, mask, jwin, twin = inputs
    pc = _port(cfg)
    ref = committed_reference(xyz, mask, jwin)
    out = {}
    for kind, imu in CASES:
        starts = STARTS[kind]
        tw = twin if imu else None
        states = port_start_states(pc, xyz, mask, tw, starts)
        if kind == "chunk":
            chunk = treplay.make_batched_chunk(pc, with_imu=imu,
                                               static_cadence=False)
            wins = None if tw is None else TWindow(
                *(_t(_chunk_of(w, starts)) for w in tw))
            with no_fallback_warnings():
                states, outs = chunk(states, TRaw(_t(_chunk_of(xyz, starts)),
                                                  _t(_chunk_of(mask, starts))),
                                     imu_windows=wins)
            packed = outs.packed
        else:
            states, packed = port_steps(treplay.make_batched_step(pc, imu),
                                        states, xyz, mask, tw, starts)
        out[_case_name(kind, imu)] = (ref[_case_name(kind, imu)],
                                      packed.numpy(), port_counters(states))
    return out


def _assert_matches_jax(name, runs, imu: bool):
    (pj, cj), pt, ct = runs[name]
    b = len(SPEEDS)
    assert pt.shape == pj.shape == (b, K, 29)
    for i in range(b):
        np.testing.assert_allclose(pt[i, :, :18], pj[i, :, :18], rtol=0,
                                   atol=1e-3 if imu else 1e-4,
                                   err_msg=f"{name} lane {i}")
        if not imu:
            np.testing.assert_array_equal(pt[i, :, 18:], pj[i, :, 18:],
                                          err_msg=f"{name} lane {i}")
            continue
        # The flags exactly; the telemetry counters and the archive's
        # cursor follow the deskewed clouds and the map, which the IMU
        # parity's rounding moves (test_torch_replay's IMU tolerances).
        np.testing.assert_array_equal(pt[i, :, 18:20], pj[i, :, 18:20],
                                      err_msg=f"{name} lane {i}")
        assert np.abs(pt[i, :, 20:28] - pj[i, :, 20:28]).max() <= 2
        np.testing.assert_allclose(pt[i, :, 28], pj[i, :, 28], rtol=0.05)
    # The lanes' counters after the run: sweep, bundles forwarded,
    # initialized, odometry and mapping frames exactly (with the IMU the
    # archive's cursors follow the map).
    np.testing.assert_array_equal(ct[:, :5] if imu else ct,
                                  cj[:, :5] if imu else cj, err_msg=name)


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_batched_step_matches_jax_at_mixed_starts(runs, imu):
    name = _case_name("step", imu)
    _assert_matches_jax(name, runs, imu)
    (pj, _), _, _ = runs[name]
    # The starts are mixed: lane 0 takes its first sweep while lane 1
    # maps, lanes 0 and 1 map on alternate sweeps, lane 2 beside lane 0.
    np.testing.assert_array_equal(pj[:, :, 18], [[0, 1, 0, 1], [1, 0, 1, 0],
                                                 [0, 1, 0, 1]])
    assert np.abs(pj[0, :, :18] - pj[2, :, :18]).max() > 1e-3


def test_dynamic_chunk_matches_jax_off_the_io_ratio_boundary(runs):
    _assert_matches_jax(_case_name("chunk", False), runs, False)
    (pj, cj), _, _ = runs[_case_name("chunk", False)]
    np.testing.assert_array_equal(pj[:, :, 18], [[1, 0, 1, 0], [1, 0, 1, 0],
                                                 [0, 1, 0, 1]])
    np.testing.assert_array_equal(cj[:, 0], np.array(STARTS["chunk"]) + K)


@pytest.mark.parametrize("kind,imu", CASES,
                         ids=[_case_name(k, i) for k, i in CASES])
def test_batched_step_matches_the_port_single_streams(runs, inputs, kind, imu):
    """Each lane of the batched run against its own single stream (the
    eager dynamic step) over the same sweeps."""
    cfg, xyz, mask, _, twin = inputs
    pc = _port(cfg)
    _, pt, ct = runs[_case_name(kind, imu)]
    for i, s0 in enumerate(STARTS[kind]):
        state, cadence = teng.EngineState.create(pc, "cpu"), teng.Cadence()
        rows = []
        for j in range(s0 + K):
            state, o = teng.step(state, TRaw(_t(xyz[i, j]), _t(mask[i, j])), pc,
                                 "auto", cadence,
                                 _twin(twin, i, j) if imu else None)
            cadence = cadence.advance(pc)
            rows.append(o.packed.numpy())
        one = np.stack(rows[s0:])
        np.testing.assert_allclose(pt[i, :, :18], one[:, :18], rtol=0,
                                   atol=1e-6, err_msg=f"lane {i}")
        np.testing.assert_array_equal(pt[i, :, 18:], one[:, 18:])
        assert ct[i, :3].tolist() == [cadence.sweep, cadence.mapping_inputs,
                                      int(cadence.initialized)]


class PoisonGraphs(EagerGraphs):
    """tests/test_torch_step_graph.py's ``EagerGraphs`` whose skipped
    regions run their Python under the stand-in and poison what they
    made (mapping's ``prepare`` and ``finish`` hand their results on)."""

    def _record(self, warm, body, what):
        cap = super()._record(warm, body, what)
        return cap._replace(graph=_PoisonReplay(body, self.host_reads))


class _PoisonReplay:
    def __init__(self, body, host_reads):
        self.body, self.host_reads = body, host_reads

    def replay(self):
        with HostReads() as mode, host_conditionals(poison=True):
            self.body()
        self.host_reads += mode.hits


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_graphed_composition_equals_the_eager_step(inputs, imu):
    """``batched_step_graphed`` through the stand-in at mixed starts,
    then at the aligned starts of a fresh batch (the same key): bit-equal
    to the eager step, one key captured, no host read in a replay."""
    cfg, xyz, mask, _, twin = inputs
    pc = _port(cfg)
    tw = twin if imu else None
    graphs = PoisonGraphs()

    def graphed(states, raw, win):
        return treplay.batched_step_graphed(graphs, pc, states, raw, win)

    eager = treplay.make_eager_batched_step(pc, imu)
    for starts in (STARTS["step"], (0, 0, 0)):
        states = port_start_states(pc, xyz, mask, tw, starts)
        s_e, p_e = port_steps(eager, states, xyz, mask, tw, starts)
        s_g, p_g = port_steps(graphed, states, xyz, mask, tw, starts)
        assert torch.equal(p_g, p_e), starts
        for a, b in zip(teng.graph_mod.leaves(s_g), teng.graph_mod.leaves(s_e)):
            assert torch.equal(a, b)
    assert len(graphs.captured) == 1 and graphs.host_reads == []


class RaiseOnHostRead(HostReads):
    """``HostReads`` that raises at the first read back to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.hits:
            raise AssertionError(f"a read back to the host: {self.hits[0]}")
        return out


def _step_without_reads(pc, inputs, imu, graphs=None):
    _, xyz, mask, _, twin = inputs
    tw = twin if imu else None
    starts = STARTS["step"]
    states = port_start_states(pc, xyz, mask, tw, starts)
    raw, win = sweep_at(xyz, mask, tw, starts, 0)
    with RaiseOnHostRead():
        if graphs is None:
            return treplay.make_batched_step(pc, imu)(states, raw, win)
        with host_conditionals(poison=True):
            return treplay.batched_step_graphed(graphs, pc, states, raw, win)


@pytest.mark.parametrize("form", ["eager", "composed"])
def test_no_host_read_inside_the_batched_step(inputs, form):
    pc = _port(inputs[0])
    graphs = PoisonGraphs() if form == "composed" else None
    for imu in (False, True):
        states, outs = _step_without_reads(pc, inputs, imu, graphs)
        assert outs.packed.shape == (len(SPEEDS), 29)


def test_a_planted_host_read_is_caught(inputs, monkeypatch):
    """A mapping gate read on the host (the "any lane due" flag, to skip
    mapping from Python) fails the test above's mode."""
    pc = _port(inputs[0])
    real = conditional.run_if_any

    def reading(flag, body):
        if not bool(conditional.running(~flag)):
            raise AssertionError("unreachable: a lane is due")
        return real(flag, body)

    monkeypatch.setattr(conditional, "run_if_any", reading)
    with pytest.raises(AssertionError, match="read back to the host"):
        _step_without_reads(pc, inputs, False)


@pytest.mark.slow
def test_committed_jax_reference_is_live(inputs):
    """The JAX runs recomputed on this build equal the committed file
    within 1e-6 (counters exactly)."""
    cfg, xyz, mask, jwin, _ = inputs
    ref = committed_reference(xyz, mask, jwin)
    for kind, imu in CASES:
        packed, counters = jax_case(cfg, xyz, mask, jwin, kind, imu)
        want = ref[_case_name(kind, imu)]
        np.testing.assert_allclose(packed, want[0], rtol=0, atol=1e-6,
                                   err_msg=_case_name(kind, imu))
        np.testing.assert_array_equal(counters, want[1])


if __name__ == "__main__":
    if sys.argv[1:] != ["regen"]:
        raise SystemExit("usage: python tests/test_torch_batched_step.py regen")
    jax.config.update("jax_platforms", "cpu")
    cfg, xyz, mask, jwin, _ = make_inputs()
    arrays = {}
    for kind, imu in CASES:
        packed, counters = jax_case(cfg, xyz, mask, jwin, kind, imu)
        arrays[f"packed_{_case_name(kind, imu)}"] = packed
        arrays[f"counters_{_case_name(kind, imu)}"] = counters
        print(f"{_case_name(kind, imu)}: packed {packed.shape}, mapping_ran "
              f"{packed[:, :, 18].tolist()}, telemetry "
              f"{packed[:, :, 20:28].sum():.0f}, counters {counters.tolist()}",
              flush=True)
    np.savez_compressed(REFERENCE, input_sha256=np.array(
        input_hash(xyz, mask, jwin)), **arrays)
    print(f"wrote {REFERENCE}")
