"""The batched per-sweep step on the card: graphed against eager.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine with only PyTorch and
the CUDA toolkit:

    python -m pytest tests/test_torch_batched_step_cuda.py -m cuda --noconftest

At the configuration of tests/test_torch_step_graph.py (the port's
``tiny_config()`` with GNs of three phases) on ``cuda:0``, three lanes
of distinct sequences: ``parallel/replay.py::make_batched_step`` (the
per-sweep graphs, one graph a sweep shape) against
``make_eager_batched_step`` on the same input, with and without IMU
windows, at mixed starts (a fresh lane, one after 1 sweep, one after 2)
and at aligned starts; packed rows and states bit-equal, the four
kernels' launches counted on the card equal to those the eager run
needed (``launches.needed``: its launches whose conditional regions'
predicates all held). One key serves both mixes; the second run
captures nothing and runs under ``torch.cuda.set_sync_debug_mode(
"error")``. The graph holds a conditional node for each GN phase and
each iteration after a phase's first, and one each for mapping's
``prepare`` and ``finish``. Aligned lanes through
``make_batched_chunk(static_cadence=False)`` equal the static batched
chunk (its CUDA graphs) bit for bit.

Tolerance: none. A graph replays the eager step's kernels on the same
inputs.
"""

import pytest
import torch
from test_torch_step_graph import MAP_PHASES, ODO_PHASES, _cfg

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops import launches
from loam_velodyne_torch.ops.imu import ImuWindow
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay

pytestmark = pytest.mark.cuda

B, SEQ, K, CAP = 3, 8, 4, 256


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _inputs(dev):
    cfg = _cfg()
    xyz, mask, wins = [], [], []
    for lane in range(B):
        sweeps, _ = synthetic.noisy_turning(SEQ, cfg.lidar, seed=3 + lane,
                                            speed=1.0 - 0.2 * lane)
        x, m = synthetic.pad_sweeps(sweeps, CAP)
        xyz.append(torch.from_numpy(x))
        mask.append(torch.from_numpy(m))
        tracker = ImuTracker()
        for t, rpy, acc in synthetic.imu_stream(SEQ, gain=1.0 - 0.25 * lane):
            tracker.push_state(t, rpy, acc)
        wins.append([tracker.window_for_sweep(0.1 * k, device=dev)
                     for k in range(SEQ)])
    return cfg, torch.stack(xyz).to(dev), torch.stack(mask).to(dev), wins


def _launches():
    launches.settle()
    return [f.launches for f in graph_mod.COUNTED]


def _zero():
    launches.settle()
    for f in graph_mod.COUNTED:
        f.launches = 0


def _equal_trees(a, b):
    la, lb = graph_mod.leaves(a), graph_mod.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _sweep(xyz, mask, wins, starts, k, imu):
    idx = [s + k for s in starts]
    raw = RawSweep(torch.stack([xyz[i, j] for i, j in enumerate(idx)]),
                   torch.stack([mask[i, j] for i, j in enumerate(idx)]))
    win = None if not imu else ImuWindow(*(torch.stack(a) for a in zip(
        *(wins[i][j] for i, j in enumerate(idx)))))
    return raw, win


def _start(cfg, xyz, mask, wins, starts, imu):
    """Each lane's state after its first ``starts[i]`` sweeps (the eager
    batched step at B = 1), stacked."""
    eager = replay.make_eager_batched_step(cfg, imu)
    lanes = []
    for i, s0 in enumerate(starts):
        state = replay.create_states(cfg, 1, xyz.device)
        for j in range(s0):
            win = None if not imu else ImuWindow(
                *(t[None] for t in wins[i][j]))
            state, _ = eager(state, RawSweep(xyz[i, j][None], mask[i, j][None]),
                             win)
        lanes.append(replay.lane(state, 0))
    return replay.stack_states(lanes)


def _run(step, states, xyz, mask, wins, starts, imu, no_sync_from=K):
    rows = []
    for k in range(K):
        raw, win = _sweep(xyz, mask, wins, starts, k, imu)
        if k == no_sync_from:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            states, outs = step(states, raw, win)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rows.append(outs.packed)
    torch.cuda.synchronize()
    return states, torch.stack(rows, 1)


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_batched_step_graphed_equals_eager(imu):
    dev = _device()
    cfg, xyz, mask, wins = _inputs(dev)
    graphs = graph_mod.sweep_graphs(cfg, dev)
    step = replay.make_batched_step(cfg, imu)
    eager = replay.make_eager_batched_step(cfg, imu)
    before, keys = set(graphs.stats), None
    for run, starts in enumerate(((0, 1, 2), (0, 0, 0))):
        start = _start(cfg, xyz, mask, wins, starts, imu)
        _zero()
        with launches.needed() as needed:
            want_state, want = _run(eager, start, xyz, mask, wins, starts, imu)
        tally = needed()
        want_launches = [tally.get(f.__name__, 0) for f in graph_mod.COUNTED]
        _zero()
        got_state, got = _run(step, start, xyz, mask, wins, starts, imu,
                              no_sync_from=0 if run else K)
        assert torch.equal(got, want), starts
        _equal_trees(got_state, want_state)
        assert _launches() == want_launches and all(want_launches)
        lane_keys = set(graphs.stats) - before
        if keys is None:
            keys = lane_keys
        assert lane_keys == keys and len(keys) == 1
    st = graphs.stats[keys.pop()]
    assert st.nodes and st.pool_bytes > 0
    # A node for each GN phase and each iteration after a phase's first
    # (odometry 12 iterations refreshed every 5, mapping 5 every 2), and
    # mapping's prepare and finish.
    assert st.conditional_nodes == (ODO_PHASES + (12 - ODO_PHASES)
                                    + MAP_PHASES + (5 - MAP_PHASES) + 2)


def test_dynamic_chunk_equals_the_static_chunk_when_aligned():
    dev = _device()
    cfg, xyz, mask, _ = _inputs(dev)
    raws = RawSweep(xyz[:, :4], mask[:, :4])
    _zero()
    s_static, o_static = replay.make_batched_chunk(cfg)(
        replay.create_states(cfg, B, dev), raws)
    static_launches = _launches()
    _zero()
    s_dyn, o_dyn = replay.make_batched_chunk(cfg, static_cadence=False)(
        replay.create_states(cfg, B, dev), raws)
    torch.cuda.synchronize()
    assert torch.equal(o_dyn.packed, o_static.packed)
    _equal_trees(s_dyn, s_static)
    assert _launches() == static_launches
