"""The compiled chunk on the CPU: what ``models/graph.py`` rests on.

A CUDA graph captures only work that never reads back to the host, and
bakes in every Python branch and constant of the group it captured.
This file holds both on the CPU, at the port's ``tiny_config()``:

- The static chunk, single stream (``engine.run_chunk``) and batched
  (``make_batched_chunk`` at B = 2, the eager form on the CPU), with
  and without IMU windows, runs under a ``TorchDispatchMode`` that
  records every operation that reads a tensor back to the host:
  ``_local_scalar_dense`` (``bool()``, ``int()``, ``.item()``),
  ``nonzero``, ``masked_select``, ``eigh``, ``unique``, ``bincount``,
  ``repeat_interleave`` with tensor repeats, and indexing with a
  boolean mask. None may occur. A ``bool()``, an ``.item()`` or a
  boolean index planted in a patched copy of the step must be caught.
- The groups: a chunk of 8 sweeps from a fresh state has two branches
  (the first group, whose first sweep is odometry's first, and the
  steady groups), a later chunk one; a chunk off the io_ratio boundary
  is refused. Each group function built once per branch, as a graph is
  captured once per key, and applied to every group of its branch
  (with another sweep count and mapping input count than it was built
  with) gives the eager chunk's outputs and state bit for bit over two
  chunks.
- The eager chunk leaves its input state as it was (the graphs' warm-up
  relies on it), and ``ChunkGraphs`` raises on the CPU, where
  ``Engine.run_chunk`` and ``make_batched_chunk`` run eagerly.

The card's side (graphed against eager, bit for bit, with the launch
counts) is tests/test_torch_graph_cuda.py and chip_smoke.py's graph
phase.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops.imu import ImuWindow
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

K, B = 4, 2
CAP = 256

HOST_READ_OPS = {"aten._local_scalar_dense", "aten.nonzero",
                 "aten.masked_select", "aten._linalg_eigh", "aten.linalg_eigh",
                 "aten._unique2", "aten.unique_consecutive", "aten.bincount"}
HOST_READ_OVERLOADS = {"aten.repeat_interleave.Tensor"}
INDEX_OPS = {"aten.index", "aten.index_put", "aten.index_put_"}


class HostReads(TorchDispatchMode):
    """Records every dispatched operation that reads back to the host."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = str(func.overloadpacket)
        if packet in HOST_READ_OPS or str(func) in HOST_READ_OVERLOADS:
            self.hits.append(str(func))
        elif packet in INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1] if i is not None):
            self.hits.append(f"{func} with a boolean index")
        return func(*args, **(kwargs or {}))


def _cfg():
    """tiny_config() with two GN iterations in odometry and mapping (the
    static schedules' phases unchanged in kind), for time."""
    cfg = replay.tiny_config()
    return dataclasses.replace(
        cfg, odometry=dataclasses.replace(cfg.odometry, max_iterations=2),
        mapping=dataclasses.replace(cfg.mapping, max_iterations=2))


def _sweeps(cfg, speed=1.0):
    sweeps, _ = synthetic.noisy_turning(K, cfg.lidar, seed=3, speed=speed)
    xyz, mask = synthetic.pad_sweeps(sweeps, CAP)
    return torch.from_numpy(xyz), torch.from_numpy(mask)


def _windows():
    tracker = ImuTracker()
    for t, rpy, acc in synthetic.imu_stream(K):
        tracker.push_state(t, rpy, acc)
    rows = [tracker.window_for_sweep(0.1 * k, device="cpu") for k in range(K)]
    return ImuWindow(*(torch.stack(a) for a in zip(*rows)))


@pytest.fixture(scope="module")
def inputs():
    cfg = _cfg()
    lanes = [_sweeps(cfg, s) for s in (1.0, 0.6)]
    return cfg, lanes, _windows()


def _single(cfg, xyz, mask, wins):
    return engine_mod.run_chunk(engine_mod.EngineState.create(cfg, "cpu"),
                                RawSweep(xyz, mask), cfg, imu_windows=wins)


def _batched(cfg, lanes, wins):
    xyz = torch.stack([x for x, _ in lanes])
    mask = torch.stack([m for _, m in lanes])
    bwins = (None if wins is None
             else ImuWindow(*(torch.stack([w] * B) for w in wins)))
    chunk = replay.make_batched_chunk(cfg, with_imu=wins is not None)
    return chunk(replay.create_states(cfg, B, "cpu"), RawSweep(xyz, mask),
                 imu_windows=bwins)


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
@pytest.mark.parametrize("form", ["single", "batched"])
def test_static_chunk_reads_nothing_back(inputs, form, imu):
    cfg, lanes, wins = inputs
    wins = wins if imu else None
    with HostReads() as mode:
        if form == "single":
            _, outs = _single(cfg, *lanes[0], wins)
        else:
            _, outs = _batched(cfg, lanes, wins)
    assert mode.hits == []
    rows = outs.packed.reshape(-1, K, 29)
    assert torch.isfinite(rows).all()
    # Mapping ran on the odd sweeps: the static chunk was exercised.
    assert torch.equal(rows[:, :, 18], (torch.arange(K) % 2).float().expand(
        rows.shape[0], K))


PLANTS = {
    "bool": lambda state, raw: bool(state.sweep >= 0),
    "item": lambda state, raw: state.mapping_inputs.item(),
    "bool_index": lambda state, raw: raw.xyz[raw.mask].sum(),
}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_a_planted_host_read_is_caught(inputs, monkeypatch, plant):
    """A patched copy of the step that reads the device back: the check
    above sees it."""
    cfg, lanes, _ = inputs
    step = engine_mod.step

    def planted(state, raw, *args, **kwargs):
        PLANTS[plant](state, raw)
        return step(state, raw, *args, **kwargs)

    monkeypatch.setattr(engine_mod, "step", planted)
    with HostReads() as mode:
        _single(cfg, lanes[0][0][:2], lanes[0][1][:2], None)
    assert mode.hits, "the planted host read went unseen"


def _leaves_equal(a, b) -> bool:
    la, lb = graph_mod.leaves(a), graph_mod.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_groups_and_branches(inputs):
    cfg = inputs[0]
    graphs = graph_mod.ChunkGraphs(cfg, group=None)
    fresh = graphs.groups(8, engine_mod.Cadence())
    assert [g for g, _, _ in fresh] == [0, 1, 2, 3]
    assert len({b for _, _, b in fresh}) == 2
    # The first group: odometry's first sweep (not initialized, no input
    # to mapping), then a mapping sweep; every later group the same but
    # initialized.
    assert fresh[0][2] == ((False, False, False), (True, True, True))
    assert fresh[1][2] == fresh[3][2] == ((True, False, False), (True, True, True))
    later = graphs.groups(8, engine_mod.Cadence(8, 4, True))
    assert {b for _, _, b in later} == {fresh[1][2]}
    assert [c.sweep for _, c, _ in later] == [8, 10, 12, 14]
    for k, start in ((9, engine_mod.Cadence()),
                     (8, engine_mod.Cadence(1, 0, True))):
        with pytest.raises(ValueError, match="not aligned"):
            graphs.groups(k, start)


@pytest.mark.parametrize("form", ["single", "batched"])
def test_one_group_function_per_branch_gives_the_eager_chunk(inputs, form):
    """As the graphs do: a group function built once per branch, from the
    first group that has it, applied to every group of that branch over
    two chunks (sweeps 0-7), equals the eager chunks bit for bit."""
    cfg, lanes, _ = inputs
    if form == "single":
        xyz, mask = lanes[0]
        state0 = engine_mod.EngineState.create(cfg, "cpu")
        eager = lambda s, x, m, c: engine_mod.run_chunk(  # noqa: E731
            s, RawSweep(x, m), cfg, c)
        group = engine_mod.Engine(cfg, "cpu").graphs.group
        ax = 0
    else:
        xyz = torch.stack([x for x, _ in lanes])
        mask = torch.stack([m for _, m in lanes])
        state0 = replay.create_states(cfg, B, "cpu")
        chunk = replay.make_eager_batched_chunk(cfg)
        eager = lambda s, x, m, c: chunk(s, RawSweep(x, m), c)  # noqa: E731
        group = replay.make_batched_chunk(cfg).graphs.group
        ax = 1
    graphs = graph_mod.ChunkGraphs(cfg, group, sweep_axis=ax)
    built = {}
    state_g = state_e = state0
    cadence = engine_mod.Cadence()
    for _ in range(2):                       # two chunks of the same sweeps
        rows = []
        for g, start, branch in graphs.groups(K, cadence):
            fn = built.setdefault(branch, graphs.group(start))
            part = (lambda t: t.narrow(ax, 2 * g, 2))  # noqa: E731
            state_g, o = fn(state_g, part(xyz), part(mask), None)
            rows.append(o.packed)
        state_e, outs = eager(state_e, xyz, mask, cadence)
        assert torch.equal(torch.cat(rows, ax), outs.packed)
        assert _leaves_equal(state_g, state_e)
        for _ in range(K):
            cadence = cadence.advance(cfg)
    assert len(built) == 2


@pytest.mark.parametrize("form", ["single", "batched"])
def test_the_eager_chunk_leaves_its_state_alone(inputs, form):
    cfg, lanes, wins = inputs
    if form == "single":
        state = engine_mod.EngineState.create(cfg, "cpu")
        before = graph_mod.tree_map(torch.clone, state)
        engine_mod.run_chunk(state, RawSweep(*lanes[0]), cfg, imu_windows=wins)
    else:
        state = replay.create_states(cfg, B, "cpu")
        before = graph_mod.tree_map(torch.clone, state)
        replay.make_eager_batched_chunk(cfg)(
            state, RawSweep(torch.stack([x for x, _ in lanes]),
                            torch.stack([m for _, m in lanes])))
    assert _leaves_equal(state, before)


def test_graphs_raise_on_the_cpu_where_the_chunk_runs_eagerly(inputs):
    cfg, lanes, _ = inputs
    xyz, mask = lanes[0]
    engine = engine_mod.Engine(cfg, "cpu")
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        engine.graphs(engine.state, xyz, mask, None, engine.cadence)
    outs = engine.run_chunk(xyz, mask)
    _, want = _single(cfg, xyz, mask, None)
    assert torch.equal(outs.packed, want.packed)
    assert engine.graphs.stats == {}
    chunk = replay.make_batched_chunk(cfg)
    chunk(replay.create_states(cfg, B, "cpu"),
          RawSweep(torch.stack([xyz] * B), torch.stack([mask] * B)))
    assert chunk.graphs.stats == {}
