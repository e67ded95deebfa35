"""The per-sweep graphs on the card: graphed against the eager step.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine with only PyTorch and
the CUDA toolkit:

    python -m pytest tests/test_torch_step_graph_cuda.py -m cuda --noconftest

At the configuration of tests/test_torch_step_graph.py (the port's
``tiny_config()`` with GNs of three phases) on ``cuda:0``:
``Engine.step`` (the per-sweep graphs) against the module function
``engine.step`` (eager, the dynamic GNs reading their flag once an
iteration), and ``Engine.run_chunk(static_cadence=False)`` against the
module function ``engine.run_chunk``, with and without IMU windows,
from a fresh state: packed rows and state bit-equal, the four kernels'
launch counts equal (the graphs' counted on the card and settled,
``ops/launches.py``), and each GN key (odometry's, and
mapping's) holds conditional nodes, one for each phase and for each
iteration after a phase's first. Each key is captured at its first
sweep: a second engine of the configuration, on the same sweeps,
captures nothing and runs its sweeps after the first two under
``torch.cuda.set_sync_debug_mode("error")``, reading nothing back.

Tolerance: none. A graph replays the eager step's kernels on the same
inputs.
"""

import numpy as np
import pytest
import torch
from test_torch_step_graph import CAP, K, MAP_PHASES, ODO_PHASES, _cfg

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops import launches
from loam_velodyne_torch.ops.imu import ImuWindow
from loam_velodyne_torch.ops.scan import RawSweep

pytestmark = pytest.mark.cuda


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _inputs(dev):
    cfg = _cfg()
    sweeps, _ = synthetic.noisy_turning(K, cfg.lidar, seed=3, speed=1.0)
    xyz, mask = synthetic.pad_sweeps(sweeps, CAP)
    tracker = ImuTracker()
    for t, rpy, acc in synthetic.imu_stream(K):
        tracker.push_state(t, rpy, acc)
    wins = [tracker.window_for_sweep(0.1 * k, device=dev) for k in range(K)]
    return (cfg, torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev),
            wins)


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


def _eager(cfg, xyz, mask, wins):
    state, cadence, rows = engine_mod.EngineState.create(cfg, xyz.device), \
        engine_mod.Cadence(), []
    for i in range(K):
        state, o = engine_mod.step(state, RawSweep(xyz[i], mask[i]), cfg,
                                   "auto", cadence,
                                   None if wins is None else wins[i])
        rows.append(o.packed)
        cadence = cadence.advance(cfg)
    torch.cuda.synchronize()
    return torch.stack(rows), state


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_step_graphed_equals_eager(imu):
    dev = _device()
    cfg, xyz, mask, wins = _inputs(dev)
    wins = wins if imu else None
    _zero()
    want, want_state = _eager(cfg, xyz, mask, wins)
    eager_launches = _launches()
    graphs = graph_mod.sweep_graphs(cfg, dev)
    for run in range(2):                     # the second run captures nothing
        _zero()
        keys = set(graphs.stats)
        engine = engine_mod.Engine(cfg, dev)
        rows = []
        for i in range(K):
            if run == 1 and i == 2:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                rows.append(engine.step(xyz[i], mask[i],
                                        None if wins is None else wins[i]).packed)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert torch.equal(torch.stack(rows), want)
        _equal_trees(engine.state, want_state)
        assert _launches() == eager_launches and all(eager_launches)
        if run == 1:
            assert set(graphs.stats) == keys
    for st in graphs.stats.values():
        assert st.nodes and st.pool_bytes > 0
    # Odometry 12 iterations refreshed every 5, mapping 5 every 2: a node
    # a phase and one for each iteration after a phase's first.
    odo, mapping = graphs.stats[("odometry", True)], graphs.stats[("mapping",)]
    assert odo.conditional_nodes == ODO_PHASES + (12 - ODO_PHASES)
    assert mapping.conditional_nodes == MAP_PHASES + (5 - MAP_PHASES)


def test_dynamic_chunk_graphed_equals_eager():
    dev = _device()
    cfg, xyz, mask, wins = _inputs(dev)
    stacked = ImuWindow(*(torch.stack(a) for a in zip(*wins)))
    _zero()
    want_state, want = engine_mod.run_chunk(
        engine_mod.EngineState.create(cfg, dev), RawSweep(xyz, mask), cfg,
        imu_windows=stacked, static_cadence=False)
    torch.cuda.synchronize()
    eager_launches = _launches()
    _zero()
    engine = engine_mod.Engine(cfg, dev)
    got = engine.run_chunk(xyz, mask, stacked, static_cadence=False)
    torch.cuda.synchronize()
    assert torch.equal(got.packed, want.packed)
    _equal_trees(engine.state, want_state)
    assert _launches() == eager_launches
    assert np.array_equal(got.packed[:, 18].cpu().numpy(),
                          np.arange(K) % 2)
