"""The per-sweep graphs on the CPU: what ``models/engine.py::step_graphed``
rests on.

On the card ``Engine.step`` replays the per-sweep step as CUDA graphs of
its segments (``graph.SweepGraphs``): the front, odometry (its first
sweep, or its GN with its start and end), mapping's prepare with its
GN, and the tail, each graph captured once per key and replayed on the
slots it reads and writes; each GN phase, and each iteration after a
phase's first, is a conditional node that the card skips once the GN
has stopped. Here ``EagerGraphs`` stands in for the capture: a key's
segment is warmed up once (allocating the slots it is the first to
write, as on the card) and each replay runs the segment body (the same
function the card captures, with the same slot copies) eagerly, its
conditional nodes through tests/test_torch_conditional.py's stand-in
(a region skipped when its predicate is false; that file holds the
regions to leaving nothing born inside them behind). At the port's ``tiny_config()``
with GNs of three phases (the last one short):

- the segments composed this way give the eager dynamic ``step``'s
  packed rows and state bit for bit, over sequences with odometry's
  first sweep, mapping and no mapping sweeps, with and without IMU
  windows, GNs that stop inside a phase, GNs that run every phase
  (abort thresholds at 0) and GNs that never start (clouds too small),
  running the eager step's correspondence and k-NN searches (none in a
  skipped region), and each key captured once;
- no segment reads back to the host (``HostReads`` of
  tests/test_torch_graph.py around every replay), and a ``bool()``
  planted in a segment is caught;
- the host reads no stop flag in a graphed sweep (``HostReads`` around
  the whole step), against the eager step's one a GN iteration;
- a state written to ``Engine.state`` between sweeps (the driver's
  archive compaction, ``load_state``, a resume from a checkpoint)
  reaches the segments' inputs, and a segment output that aliases a
  slot the segment overwrites is copied before it is overwritten.

Tolerance: none. The card's side (graphed against eager with the launch
counts) is tests/test_torch_step_graph_cuda.py and chip_smoke.py's
per-sweep graph phase.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_conditional import _Searches, host_conditionals, uncounted
from test_torch_graph import HostReads

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.parallel import replay

torch.set_num_threads(1)

K = 6
CAP = 256
ODO_PHASES = 3          # 12 iterations, refreshed every 5: 5 + 5 + 2
MAP_PHASES = 3          # 5 iterations, refreshed every 2: 2 + 2 + 1


def _cfg(case: str = "stops"):
    cfg = replay.tiny_config()
    # Its sweeps keep 3-7 corners: the GNs start from 2.
    odo = dataclasses.replace(cfg.odometry, max_iterations=12,
                              corresp_refresh_every=5, min_corner_points=2)
    m = dataclasses.replace(cfg.mapping, max_iterations=5,
                            corresp_refresh_every=2, min_corner_map_points=2)
    if case == "all_phases":
        odo = dataclasses.replace(odo, delta_r_abort=0.0, delta_t_abort=0.0)
        m = dataclasses.replace(m, delta_r_abort=0.0, delta_t_abort=0.0)
    elif case == "too_small":
        odo = dataclasses.replace(odo, min_corner_points=10 ** 6)
        m = dataclasses.replace(m, min_corner_map_points=10 ** 6)
    return dataclasses.replace(cfg, odometry=odo, mapping=m)


class EagerGraphs(graph_mod.SweepGraphs):
    """``SweepGraphs`` whose graphs are their segment bodies run eagerly:
    a key is 'captured' once (the segment's warm-up), then every replay
    runs the body the card would have captured, under ``HostReads``, its
    conditional nodes through the stand-in. The warm-up's searches are
    not counted: the card's replays run the searches."""

    def __init__(self):
        super().__init__("cpu")
        self.captured = []
        self.host_reads = []

    def _record(self, warm, body, what):
        self.captured.append(what)
        with uncounted():
            warm()
        return graph_mod._Captured(_Replay(body, self.host_reads), None, None)


class _Replay:
    def __init__(self, body, host_reads):
        self.body, self.host_reads = body, host_reads

    def replay(self):
        with HostReads() as mode, host_conditionals(poison=False):
            self.body()
        self.host_reads += mode.hits


@pytest.fixture(scope="module")
def inputs():
    sweeps, _ = synthetic.noisy_turning(K, _cfg().lidar, seed=3, speed=1.0)
    xyz, mask = synthetic.pad_sweeps(sweeps, CAP)
    tracker = ImuTracker()
    for t, rpy, acc in synthetic.imu_stream(K):
        tracker.push_state(t, rpy, acc)
    wins = [tracker.window_for_sweep(0.1 * k, device="cpu") for k in range(K)]
    return torch.from_numpy(xyz), torch.from_numpy(mask), wins


def _run(cfg, inputs, imu: bool, graphs=None):
    """K sweeps from a fresh state, eager (``graphs`` None) or composed
    through ``graphs``; returns the packed rows, the state and the host's
    reads of a stop flag on each sweep."""
    xyz, mask, wins = inputs
    state, cadence = engine_mod.EngineState.create(cfg, "cpu"), engine_mod.Cadence()
    rows, reads = [], []
    for i in range(K):
        raw = engine_mod.scan_mod.RawSweep(xyz[i], mask[i])
        win = wins[i] if imu else None
        with HostReads() as mode:
            if graphs is None:
                state, outs = engine_mod.step(state, raw, cfg, "auto",
                                              cadence, win)
            else:
                state, outs = engine_mod.step_graphed(graphs, state, raw, cfg,
                                                      cadence, win)
        reads.append(sum(h.startswith("aten._local_scalar_dense")
                         for h in mode.hits))
        rows.append(outs.packed)
        cadence = cadence.advance(cfg)
    return torch.stack(rows), state, reads


def _leaves_equal(a, b) -> bool:
    la, lb = graph_mod.leaves(a), graph_mod.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


CASES = [("stops", False), ("stops", True), ("all_phases", False),
         ("too_small", True)]


@pytest.mark.parametrize("case,imu", CASES,
                         ids=[f"{c}-{'imu' if i else 'no_imu'}" for c, i in CASES])
def test_segments_compose_to_the_eager_step(inputs, monkeypatch, case, imu):
    cfg = _cfg(case)
    searches = _Searches(monkeypatch)
    want_rows, want_state, eager_reads = _run(cfg, inputs, imu)
    want = searches.take()
    graphs = EagerGraphs()
    rows, state, reads = _run(cfg, inputs, imu, graphs)
    ran = searches.take()
    assert torch.equal(rows, want_rows)
    assert _leaves_equal(state, want_state)
    # The searches the replays run (none in a skipped region): the eager
    # step's, two a refresh (corner and surf; a corner and a surf k-NN).
    assert ran == want
    # Mapping ran on the odd sweeps; every key was captured once.
    assert rows[:, 18].tolist() == [float(i % 2) for i in range(K)]
    assert len(graphs.captured) == len(set(graphs.captured))
    # No stop flag is read on the host in a graphed sweep; eagerly one a
    # GN iteration and one before it (odometry on sweeps 1-5, mapping on
    # 1, 3 and 5).
    assert reads == [0] * K and graphs.host_reads == []
    if case == "all_phases":
        # Every GN that starts runs all its phases.
        assert ran["corresp"] % (2 * ODO_PHASES) == 0
        assert ran["knn"] % (2 * MAP_PHASES) == 0
        assert 0 < ran["knn"] and 0 < ran["corresp"]
        assert all(e > 0 for e in eager_reads[1:])
    elif case == "too_small":
        assert eager_reads == [0] + [1 + i % 2 for i in range(1, K)]
        assert want == {"corresp": 0, "knn": 0}
        assert ran == {"corresp": 0, "knn": 0}
    else:
        assert all(e > 0 for e in eager_reads[1:])
        assert 0 < ran["corresp"] < 2 * ODO_PHASES * (K - 1)


def test_no_segment_reads_back(inputs):
    graphs = EagerGraphs()
    _run(_cfg(), inputs, True, graphs)
    assert graphs.replays > 0 and graphs.host_reads == []


@pytest.mark.parametrize("where", ["front", "gn_phase"])
def test_a_planted_host_read_is_caught(inputs, monkeypatch, where):
    if where == "front":
        fn = engine_mod.front
        monkeypatch.setattr(engine_mod, "front", lambda raw, win, cfg: (
            bool(raw.mask.any()), fn(raw, win, cfg))[1])
    else:
        fn = odometry_mod.gn_phase
        monkeypatch.setattr(odometry_mod, "gn_phase", lambda carry, *a: (
            carry.done.item(), fn(carry, *a))[1])
    graphs = EagerGraphs()
    _run(_cfg(), inputs, False, graphs)
    assert graphs.host_reads, "the planted host read went unseen"


def test_a_segment_output_that_aliases_a_slot_it_overwrites():
    """A segment that writes slot a anew and hands a's old value to slot
    b: b gets the old value, whichever copy comes first."""
    graphs = EagerGraphs()
    graphs.load("a", (torch.tensor([1.0]),))
    graphs.load("b", (torch.tensor([0.0]),))
    seg = graph_mod.Segment(lambda a: ((a[0] + 1,), (a[0],)), ("a",),
                            ("a", "b"))
    for _ in range(2):                     # the warm-up's capture, a replay
        graphs.run(("swap",), seg)
    assert graphs.slots["a"][0].item() == 3.0
    assert graphs.slots["b"][0].item() == 2.0


def _driver(cfg):
    return LoamDriver(cfg, "cpu", sweep_capacity=CAP, system_delay=0)


def _graphed(monkeypatch, graphs):
    """Inside the test every Engine steps through ``graphs`` (shared, as
    ``sweep_graphs`` shares them on the card)."""
    monkeypatch.setattr(engine_mod.Engine, "_per_sweep", lambda self, raw, win: (
        engine_mod.step_graphed(graphs, self.state, raw, self.cfg,
                                self.cadence, win)))


@pytest.mark.parametrize("edit", ["compaction", "load_state", "resume"])
def test_a_host_edit_of_the_state_reaches_the_segments(inputs, monkeypatch,
                                                       tmp_path, edit):
    """Sweeps 0-3, an edit of ``Engine.state`` from the host, sweeps 4-5:
    through the graphs as eagerly (trajectory and state), and the edit
    moved the state."""
    cfg = _cfg()
    xyz, mask, _ = inputs
    sweeps = [xyz[i][mask[i]].numpy() for i in range(K)]
    ckpt = str(tmp_path / "state.npz")

    def run(edited: bool):
        drv = _driver(cfg)
        for pts in sweeps[:2]:
            drv.process_sweep(pts)
        drv.save_checkpoint(ckpt)
        for pts in sweeps[2:4]:
            drv.process_sweep(pts)
        if edited and edit == "compaction":
            drv._archive_cnt_hint = cfg.mapping.archive_capacity
            drv._maybe_compact_archive()
            assert drv.metrics.counters["archive_compactions"] == 1
        elif edited and edit == "load_state":
            drv.load_checkpoint(ckpt)
        elif edited:
            drv = _driver(cfg)
            drv.checkpoint_path = ckpt
            assert drv.resume() and drv.resumed_sweeps == 2
        for pts in sweeps[4:]:
            drv.process_sweep(pts)
        return np.stack(drv.trajectory[-2:]), drv.engine.state

    want, unedited = run(True), run(False)
    assert not _leaves_equal(want[1], unedited[1])
    _graphed(monkeypatch, EagerGraphs())
    got = run(True)
    assert np.array_equal(got[0], want[0]) and _leaves_equal(got[1], want[1])
