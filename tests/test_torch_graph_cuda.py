"""The compiled chunk on the card: CUDA graphs against the eager chunk.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine with only PyTorch and
the CUDA toolkit:

    python -m pytest tests/test_torch_graph_cuda.py -m cuda --noconftest

At the port's ``tiny_config()`` on ``cuda:0``: ``Engine.run_chunk``
(graphed) against the module function ``engine.run_chunk`` (eager), and
``make_batched_chunk``'s callable (graphed) against
``make_eager_batched_chunk`` at B = 2 with and without IMU windows, over
two chunks from a fresh state (the first group, then steady groups):
outputs and state bit-equal, the four kernels' launch counts equal. A
graphed chunk after the first runs under
``torch.cuda.set_sync_debug_mode("error")``. The returned state is the
caller's own: a later call leaves it as it was.

Tolerance: none. A graph replays the eager chunk's kernels on the same
inputs.
"""

import numpy as np
import pytest
import torch

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops.imu import ImuWindow
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay

pytestmark = pytest.mark.cuda

K, CHUNKS, B, CAP = 4, 2, 2, 256


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _inputs(dev, lanes: int):
    cfg = replay.tiny_config()
    xyz, mask = [], []
    for i in range(lanes):
        sweeps, _ = synthetic.noisy_turning(K * CHUNKS, cfg.lidar, seed=3 + i,
                                            speed=1.0 - 0.3 * i)
        x, m = synthetic.pad_sweeps(sweeps, CAP)
        xyz.append(x)
        mask.append(m)
    return (cfg, torch.from_numpy(np.stack(xyz)).to(dev),
            torch.from_numpy(np.stack(mask)).to(dev))


def _windows(dev, lanes: int):
    tracker = ImuTracker()
    for t, rpy, acc in synthetic.imu_stream(K * CHUNKS):
        tracker.push_state(t, rpy, acc)
    rows = [tracker.window_for_sweep(0.1 * k, device=dev)
            for k in range(K * CHUNKS)]
    one = ImuWindow(*(torch.stack(a) for a in zip(*rows)))
    return ImuWindow(*(torch.stack([w] * lanes) for w in one))


def _launches():
    return [f.launches for f in graph_mod.COUNTED]


def _zero():
    for f in graph_mod.COUNTED:
        f.launches = 0


def _equal_trees(a, b):
    la, lb = graph_mod.leaves(a), graph_mod.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_engine_graphed_equals_eager():
    dev = _device()
    cfg, xyz, mask = _inputs(dev, 1)
    xyz, mask = xyz[0], mask[0]
    _zero()
    state, cadence, eager = engine_mod.EngineState.create(cfg, dev), \
        engine_mod.Cadence(), []
    for c in range(CHUNKS):
        s = slice(c * K, (c + 1) * K)
        state, o = engine_mod.run_chunk(state, RawSweep(xyz[s], mask[s]), cfg,
                                        cadence)
        eager.append(o.packed)
        for _ in range(K):
            cadence = cadence.advance(cfg)
    eager_launches = _launches()
    _zero()
    engine = engine_mod.Engine(cfg, dev)
    graphed = []
    for c in range(CHUNKS):
        s = slice(c * K, (c + 1) * K)
        if c == CHUNKS - 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            graphed.append(engine.run_chunk(xyz[s], mask[s]).packed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _launches() == eager_launches and all(eager_launches)
    assert torch.equal(torch.cat(graphed), torch.cat(eager))
    _equal_trees(engine.state, state)
    assert len(engine.graphs.stats) == 2        # the first and steady groups
    for st in engine.graphs.stats.values():
        assert st.nodes and st.pool_bytes > 0


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_batched_graphed_equals_eager(imu):
    dev = _device()
    cfg, xyz, mask = _inputs(dev, B)
    wins = _windows(dev, B) if imu else None
    outs = {}
    for name, chunk in (("eager", replay.make_eager_batched_chunk(cfg, imu)),
                        ("graphed", replay.make_batched_chunk(cfg, imu))):
        _zero()
        states, cadence, rows = replay.create_states(cfg, B, dev), \
            engine_mod.Cadence(), []
        for c in range(CHUNKS):
            s = slice(c * K, (c + 1) * K)
            w = None if wins is None else ImuWindow(*(a[:, s] for a in wins))
            states, o = chunk(states, RawSweep(xyz[:, s], mask[:, s]), cadence, w)
            rows.append(o.packed)
            for _ in range(K):
                cadence = cadence.advance(cfg)
        torch.cuda.synchronize()
        outs[name] = (torch.cat(rows, 1), states, _launches())
    assert torch.equal(outs["graphed"][0], outs["eager"][0])
    _equal_trees(outs["graphed"][1], outs["eager"][1])
    assert outs["graphed"][2] == outs["eager"][2] and all(outs["eager"][2])


def test_returned_state_is_the_callers():
    """A call returns fresh tensors: the next call does not overwrite the
    state the first one returned, and the caller's state is read, not
    written."""
    dev = _device()
    cfg, xyz, mask = _inputs(dev, 1)
    engine = engine_mod.Engine(cfg, dev)
    start = engine.state
    start_copy = graph_mod.tree_map(torch.clone, start)
    engine.run_chunk(xyz[0, :K], mask[0, :K])
    first = engine.state
    first_copy = graph_mod.tree_map(torch.clone, first)
    engine.run_chunk(xyz[0, K:2 * K], mask[0, K:2 * K])
    torch.cuda.synchronize()
    _equal_trees(start, start_copy)
    _equal_trees(first, first_copy)
