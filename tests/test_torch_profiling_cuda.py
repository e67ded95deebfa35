"""The port's tracing on the card (``utils/profiling.py``,
``ops/launches.py``, ``csrc/stamp.cu``).

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine with only PyTorch and
the CUDA toolkit:

    python -m pytest tests/test_torch_profiling_cuda.py -m cuda --noconftest

- The clock mapping: stamps launched on an idle card, mapped onto
  ``perf_counter_ns``, lie between the host's reads around their launch
  and their wait, within the calibration's error bound (under 50 us).
  Two stamps around a known kernel (``torch.cuda._sleep``, ~1 ms)
  bracket the profiler's interval of that kernel on the card's clock,
  and measure the profiler's length from one to the other within 5 us.
- At tests/test_torch_step_graph.py's configuration (the port's
  ``tiny_config()`` with GNs of three phases), the per-sweep graphs
  (``Engine.step``) and the eager step stamp the same layers in the same
  order each sweep.
- The refresh counters of the graphed batched chunk and batched step
  (three lanes of distinct sequences) equal those of their eager forms,
  which weight each count by its regions' predicates.
- With tracing off, a fresh capture of every per-sweep and chunk key
  holds as many nodes as one with the tracing's entry points removed,
  and fewer than one with tracing on.

Tolerance: none, but for the clock comparison (its bound).
"""

import time

import pytest
import torch
from test_torch_step_graph import _cfg
from torch.autograd import DeviceType

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops import launches
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay
from loam_velodyne_torch.utils import profiling

pytestmark = pytest.mark.cuda

B, K, CAP = 3, 4, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    known = set(graph_mod._sweep_graphs)
    try:
        yield torch.device("cuda:0")
    finally:
        profiling.disable()
        profiling.clear()
        for key in set(graph_mod._sweep_graphs) - known:
            del graph_mod._sweep_graphs[key]


def _fresh_sweep_graphs(monkeypatch, cfg, dev) -> None:
    """The configuration's per-sweep graphs, captured anew in the test
    (with the test's tracing switch)."""
    monkeypatch.setitem(graph_mod._sweep_graphs, (cfg, dev),
                        graph_mod.SweepGraphs(dev))


def _lanes(dev):
    cfg = _cfg()
    xyz, mask = [], []
    for lane in range(B):
        sweeps, _ = synthetic.noisy_turning(K, cfg.lidar, seed=3 + lane,
                                            speed=1.0 + 3.0 * lane)
        x, m = synthetic.pad_sweeps(sweeps, CAP)
        xyz.append(torch.from_numpy(x))
        mask.append(torch.from_numpy(m))
    return cfg, torch.stack(xyz).to(dev), torch.stack(mask).to(dev)


def test_stamps_hold_a_kernel_within_the_calibration(card):
    profiling.enable(card)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    profiling.clear()
    brackets = []
    for _ in range(8):
        torch.cuda.synchronize()
        h0 = time.perf_counter_ns()
        profiling.stamp("front")
        profiling.stamp("front", end=True)
        torch.cuda.synchronize()
        brackets.append((h0, time.perf_counter_ns()))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiling.stamp("front")
        torch.cuda._sleep(2_000_000)
        profiling.stamp("front", end=True)
        torch.cuda.synchronize()
    rec = profiling.records()
    err = rec["clock_error_ns"]
    assert err < 50_000
    ivs = profiling.intervals(rec["stamps"])
    assert len(ivs) == len(brackets) + 1
    # Mapped onto the host's clock, each stamp lies inside the host's
    # reads around its launch and its wait, within the bound.
    for (h0, h1), (_, a, b, _) in zip(brackets, ivs):
        assert h0 - err <= a <= b <= h1 + err
    # On the card's own clock, as the profiler reads it, the two stamps
    # bracket the kernel, and the stamped interval is as long as the
    # profiler's from one stamp to the other (the globaltimer's tick).
    _, a, b, _ = ivs[-1]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    first, last = sorted((e for e in events if "stamp" in e.name),
                         key=lambda e: e.time_range.start)
    kernel, = [e for e in events if "stamp" not in e.name
               and e.time_range.end - e.time_range.start > 500]
    print(f"stamped {(b - a) / 1e3:.3f} us, profiler stamp to stamp "
          f"{last.time_range.start - first.time_range.start:.3f} us, kernel "
          f"{kernel.time_range.end - kernel.time_range.start:.3f} us, "
          f"calibration +-{err / 1e3:.2f} us")
    assert first.time_range.end <= kernel.time_range.start
    assert kernel.time_range.end <= last.time_range.start
    assert abs((b - a) / 1e3 - (last.time_range.start
                                - first.time_range.start)) < 5.0
    assert (b - a) / 1e3 >= kernel.time_range.end - kernel.time_range.start


def _layers_per_step(rec) -> list:
    steps: dict = {}
    for s in rec["stamps"]:
        if not s.end and s.name not in ("step",) \
                and not s.name.startswith("copy."):
            steps.setdefault(s.step, []).append(s.name)
    return [steps[k] for k in sorted(steps)]


def test_graphed_and_eager_steps_stamp_the_same_layers(card, monkeypatch):
    profiling.enable(card)
    cfg, xyz, mask = _lanes(card)
    _fresh_sweep_graphs(monkeypatch, cfg, card)
    xyz, mask = xyz[0], mask[0]
    for run in range(2):                       # the first run captures
        profiling.clear()
        engine = engine_mod.Engine(cfg, card)
        for i in range(K):
            with profiling.span("graphed", step=True):
                engine.step(xyz[i], mask[i])
        graphed = _layers_per_step(profiling.records())
    profiling.clear()
    state, cadence = engine_mod.EngineState.create(cfg, card), \
        engine_mod.Cadence()
    for i in range(K):
        with profiling.span("eager", step=True):
            state, _ = engine_mod.step(state, RawSweep(xyz[i], mask[i]), cfg,
                                       "auto", cadence)
        cadence = cadence.advance(cfg)
    eager = _layers_per_step(profiling.records())
    assert graphed == eager
    assert eager[0] == ["front", "odometry", "tail"]
    assert "mapping.gn" in eager[1]


def _counts(fn) -> dict:
    profiling.clear()
    fn()
    torch.cuda.synchronize()
    launches.settle()
    return profiling.records()["counters"]


@pytest.mark.parametrize("form", ["chunk", "step"])
def test_graphed_refresh_counts_equal_the_eager_expectation(card, form,
                                                           monkeypatch):
    profiling.enable(card)
    cfg, xyz, mask = _lanes(card)
    _fresh_sweep_graphs(monkeypatch, cfg, card)
    if form == "chunk":
        graphed_fn = replay.make_batched_chunk(cfg)
        eager_fn = replay.make_eager_batched_chunk(cfg)

        def run(fn):
            return lambda: fn(replay.create_states(cfg, B, card),
                              RawSweep(xyz, mask))
    else:
        graphed_fn = replay.make_batched_step(cfg)
        eager_fn = replay.make_eager_batched_step(cfg)

        def run(fn):
            def sweeps():
                states = replay.create_states(cfg, B, card)
                for k in range(K):
                    states, _ = fn(states, RawSweep(xyz[:, k], mask[:, k]))
            return sweeps
    _counts(run(graphed_fn))                   # captures
    graphed = _counts(run(graphed_fn))
    eager = _counts(run(eager_fn))
    print(form, "graphed", graphed, "eager", eager)
    assert graphed == eager
    run_, running = graphed["odometry.refresh"]
    assert 0 < running <= run_ and run_ % B == 0
    assert graphed["mapping.refresh"][0] > 0


def _node_counts(cfg, xyz, mask, dev) -> dict:
    """Nodes of every key of fresh per-sweep graphs (four sweeps of one
    lane) and a fresh batched chunk (the lanes, K sweeps)."""
    graphs = graph_mod.SweepGraphs(dev)
    state, cadence = engine_mod.EngineState.create(cfg, dev), \
        engine_mod.Cadence()
    for i in range(K):
        state, _ = engine_mod.step_graphed(
            graphs, state, RawSweep(xyz[0, i], mask[0, i]), cfg, cadence)
        cadence = cadence.advance(cfg)
    chunk = replay.make_batched_chunk(cfg)
    chunk(replay.create_states(cfg, B, dev), RawSweep(xyz, mask))
    torch.cuda.synchronize()
    out = {("sweep",) + tuple(map(str, k)): s.nodes
           for k, s in graphs.stats.items()}
    out.update({("chunk", str(k[1]), str(k[3])): s.nodes
                for k, s in chunk.graphs.stats.items()})
    return out


def test_tracing_off_adds_no_node(card, monkeypatch):
    cfg, xyz, mask = _lanes(card)
    off = _node_counts(cfg, xyz, mask, card)
    with monkeypatch.context() as m:
        m.setattr(profiling, "stamp", lambda *a, **k: None)
        m.setattr(profiling, "stamps", lambda *a, **k: profiling._OFF)
        m.setattr(launches, "lanes", lambda *a, **k: None)
        removed = _node_counts(cfg, xyz, mask, card)
    profiling.enable(card)
    on = _node_counts(cfg, xyz, mask, card)
    profiling.disable()
    print("nodes off", off, "on", on)
    assert off == removed
    assert set(on) == set(off) and all(on[k] > off[k] for k in off)
