"""The port's tracing (``utils/profiling.py``, ``ops/launches.py``) on the
CPU: the switch, spans, stamps, the refresh counters, the summary's
arithmetic, the exporter, and the benchmark's readers of them
(``loam_bench/program_trace.py``, ``loam_bench/metrics/``).

On the CPU a stamp writes the host's clock with torch operations into a
ring on the CPU, so the stand-in of a conditional node
(``test_torch_conditional.host_conditionals``) drops a stamp or a count
inside a region it skips, as the card skips the node. Tolerance: none
(counts are exact; times are compared only as the records give them).
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from typing import NamedTuple

import pytest
import torch
from test_torch_conditional import (_batched, _cfg, _lanes, host_conditionals,
                                    host_node)

from loam_bench import program_trace, spec
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.models import conditional
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.ops import launches
from loam_velodyne_torch.parallel import replay
from loam_velodyne_torch.utils import profiling
from loam_velodyne_torch.utils.profiling import SpanRecord, StampRecord

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NEW_METRICS = ("features.device_ms_per_step", "odometry.device_ms_per_step",
               "mapping.device_ms_per_step", "device.gap_ms_per_step",
               "driver.enqueue_ms_per_sweep",
               "driver.cadence_device_ms_per_sweep",
               "odometry.refresh_lane_use_pct", "mapping.refresh_lane_use_pct")


@pytest.fixture
def traced():
    """Tracing on the CPU for the test, from empty records; off after."""
    profiling.enable(CPU)
    profiling.clear()
    try:
        yield
    finally:
        profiling.disable()
        profiling.clear()


def _tiny_driver(n: int = 4):
    cfg = replay.tiny_config()
    sweeps, _ = synthetic.noisy_turning(n, cfg.lidar, seed=3, speed=1.0)
    return LoamDriver(cfg, "cpu", sweep_capacity=256, system_delay=0), sweeps


def test_tracing_off_records_and_dispatches_nothing(monkeypatch):
    """Off (the default): a driver's sweeps and an eager batched chunk with
    GN regions record no span or stamp and call neither the stamp nor the
    counter op; the spans still time themselves for the driver's views."""
    assert not profiling.enabled()
    profiling.clear()

    def refused(*args, **kwargs):
        raise AssertionError("a tracing op was dispatched with tracing off")

    monkeypatch.setattr(launches, "stamp", refused)
    monkeypatch.setattr(launches, "_lanes_running_op", refused)
    drv, sweeps = _tiny_driver()
    for pts in sweeps:
        drv.process_sweep(pts)
    cfg = _cfg("stops", odo_every=2, map_every=1)
    _batched(cfg, *_lanes(cfg, "distinct"), None)
    rec = profiling.records()
    assert rec["spans"] == [] and rec["stamps"] == []
    assert len(drv.step_times) == len(sweeps) and all(
        t > 0 for t in drv.step_times)
    assert drv.metrics.timings["step"] == drv.step_times
    assert "surround_dispatch" not in drv.metrics.timings


def test_spans_nest_and_share_their_step(traced):
    """A step span opens a step that every span inside it shares, with its
    parent; a span outside any step has none; a second step gets its own
    id; the step's stamps bracket it."""
    with profiling.span("outside"):
        pass
    with profiling.span("a", step=True, steps=3):
        with profiling.span("b"):
            with profiling.span("c", step=True):
                profiling.stamp("front")
                profiling.stamp("front", end=True)
    with profiling.span("d", step=True):
        pass
    rec = profiling.records()
    by = {s.name: s for s in rec["spans"]}
    assert by["outside"].step is None and by["outside"].parent is None
    assert by["a"].parent is None and by["a"].steps == 3
    assert by["b"].parent == by["a"].id and by["c"].parent == by["b"].id
    assert by["c"].steps == 0                     # joined a's step
    assert by["a"].step == by["b"].step == by["c"].step != by["d"].step
    assert all(s.t0 <= s.t1 for s in rec["spans"])
    assert by["a"].t0 <= by["b"].t0 <= by["c"].t0 <= by["c"].t1 <= by["a"].t1
    names = [(s.name, s.end, s.step) for s in rec["stamps"]]
    a, d = by["a"].step, by["d"].step
    assert names == [("step", False, a), ("front", False, a),
                     ("front", True, a), ("step", True, a),
                     ("step", False, d), ("step", True, d)]
    assert rec["clock_error_ns"] == 0.0 and rec["lost"] == 0


def test_driver_views_are_its_spans(traced):
    """With tracing on, ``step_times`` / ``timings["step"]`` are the
    ``engine.enqueue`` start to the ``driver.readback`` end of each
    ``driver.process_sweep`` step, and ``run_live``'s events its spans'
    durations; every sweep stamps the layers in the same order."""
    drv, sweeps = _tiny_driver()
    for pts in sweeps:
        drv.process_sweep(pts)
    rec = profiling.records()
    steps = {}
    for s in rec["spans"]:
        steps.setdefault(s.step, {})[s.name] = s
    assert len(steps) == len(sweeps)
    want = [(v["driver.readback"].t1 - v["engine.enqueue"].t0) / 1e9
            for _, v in sorted(steps.items())]
    assert drv.step_times == want == drv.metrics.timings["step"]
    for v in steps.values():
        assert {"driver.pad", "driver.consume"} <= set(v)
        assert all(x.parent == v["driver.process_sweep"].id
                   for k, x in v.items() if k != "driver.process_sweep"
                   and k != "driver.surround")
    layers = {}
    for s in rec["stamps"]:
        if not s.end and s.name != "step":
            layers.setdefault(s.step, []).append(s.name)
    assert all(v[:2] == ["front", "odometry"] and v[-1] in ("tail", "surround")
               for v in layers.values())
    profiling.clear()
    live, sweeps = _tiny_driver()
    lat = live.run_live(sweeps)
    rec = profiling.records()
    enq = [s for s in rec["spans"] if s.name == "engine.enqueue"]
    cons = [s for s in rec["spans"] if s.name == "driver.consume"]
    assert len(lat) == len(live.live_events) == len(enq) == len(cons)
    for ev, e, c, dt in zip(live.live_events, enq, cons, lat):
        assert ev["dispatch_ms"] == pytest.approx((e.t1 - e.t0) / 1e6,
                                                  rel=1e-12)
        assert ev["consume_ms"] == pytest.approx((c.t1 - c.t0) / 1e6,
                                                 rel=1e-12)
        assert dt == (c.t1 - e.t0) / 1e9


def test_stamp_and_count_under_vmap_are_unbatched(traced):
    """Under vmap over three lanes a stamped layer stamps once, and a
    refresh region counts its three lanes and its running lanes once."""
    @profiling.stamped("front")
    def layer(x):
        return x * 2

    def lane(x, done):
        conditional.run_if_running(done, _counted("odometry.refresh", done),
                                   _Carry(x))
        return layer(x)

    torch.func.vmap(lane)(torch.ones(3, 4),
                          torch.tensor([True, False, False]))
    launches.settle()
    rec = profiling.records()
    assert [(s.name, s.end) for s in rec["stamps"]] == [("front", False),
                                                        ("front", True)]
    assert rec["counters"]["odometry.refresh"] == (3, 2)


class _Carry(NamedTuple):
    x: torch.Tensor


def _counted(name: str, done: torch.Tensor):
    """A region body that counts its lanes as a GN refresh phase does
    (``done`` its stop flags) and changes nothing."""
    def body(c):
        launches.lanes(name, done)
        return c
    return body


def _skipped(node):
    """What a region skipped by ``node`` (a stand-in of the IF node)
    leaves in the records: its stamps and its count."""
    profiling.clear()
    conditional.node = node

    done = torch.tensor(True)

    def body(c):
        profiling.stamp("mapping.gn")
        profiling.stamp("mapping.gn", end=True)
        return _counted("mapping.refresh", done)(_Carry(c.x + 1))

    conditional.run_if_running(done, body, _Carry(torch.tensor(1.0)))
    launches.settle()
    rec = profiling.records()
    return [s.name for s in rec["stamps"]], rec["counters"]["mapping.refresh"]


def test_a_skipped_region_records_nothing(traced):
    """Through the CPU stand-in of a captured IF node, a region whose
    predicate is false leaves no stamp and no count, and a running one
    leaves both. A mutated stand-in that runs a skipped region's body
    anyway is caught: its stamps and count show."""
    with host_conditionals():
        assert _skipped(conditional.node) == ([], (0, 0))

        def runs_anyway(pred, region):
            region()

        assert _skipped(runs_anyway) == (["mapping.gn", "mapping.gn"], (1, 0))
        profiling.clear()
        conditional.node = lambda pred, region: host_node(pred, region)
        done = torch.tensor(False)
        conditional.run_if_running(done, _counted("mapping.refresh", done),
                                   _Carry(torch.tensor(1.0)))
        launches.settle()
        assert profiling.records()["counters"]["mapping.refresh"] == (1, 1)


@pytest.mark.parametrize("gn", ["odometry", "mapping"])
def test_refresh_counts_of_a_batched_gn_by_hand(traced, monkeypatch, gn):
    """An eager batched GN of five phases (``gn_phases``, each phase
    counting as ``gn_phase`` does) over four lanes that stop after phases
    1, 3 and 4 and one that never started: each phase runs for the four
    lanes while any runs (not the fifth), and counts the lanes running at
    its start. The stand-in of the captured nodes counts the same."""
    mod = odometry_mod if gn == "odometry" else mapping_mod
    name = f"{gn}.refresh"
    cfg = replay.tiny_config()
    section = cfg.odometry if gn == "odometry" else cfg.mapping
    section = dataclasses.replace(section, max_iterations=5,
                                  corresp_refresh_every=1)
    cfg = dataclasses.replace(cfg, **{gn: section})

    def phase(c, p, stops, *rest):
        # The phase's count, as the GN's own phase makes it, then a stop
        # after the lane's last phase.
        launches.lanes(name, c.done)
        return c._replace(done=c.done | (stops <= p + 1))

    monkeypatch.setattr(mod, "gn_phase", phase)
    stops = torch.tensor([1, 3, 4, 0])

    def lane(s):
        carry = odometry_mod.gn_start(torch.zeros(6), s > 0)
        if gn == "odometry":
            return mod.gn_phases(carry, s, None, None, None, cfg).done
        return mod.gn_phases(carry, s, cfg).done

    # Running at each phase's start: 3, 2, 2, 1 of 4 lanes.
    want = (4 * 4, 3 + 2 + 2 + 1)
    assert torch.func.vmap(lane)(stops).all()
    launches.settle()
    assert profiling.records()["counters"][name] == want
    profiling.clear()
    with host_conditionals(poison=False):
        torch.func.vmap(lane)(stops)
    launches.settle()
    assert profiling.records()["counters"][name] == want


def test_refresh_counts_eager_equal_the_stand_in(traced):
    """The eager batched chunk of two lanes whose GNs stop apart counts, by
    its regions' predicates, what the stand-in of its captured nodes
    counts, and its lanes' refreshes run exceed those for running lanes."""
    cfg = _cfg("stops", odo_every=2, map_every=1)
    xyz, mask = _lanes(cfg, "distinct")
    _batched(cfg, xyz, mask, None)
    launches.settle()
    eager = profiling.records()["counters"]
    profiling.clear()
    with host_conditionals():
        _batched(cfg, xyz, mask, None)
    launches.settle()
    assert profiling.records()["counters"] == eager
    run, running = eager["odometry.refresh"]
    assert 0 < running < run and run % 2 == 0
    assert eager["mapping.refresh"][0] > 0


def _stamps(step, *items):
    """StampRecords of one step: (name, start, end) intervals, bracketed
    by the step's own stamps at the first start and the last end."""
    out = [StampRecord(items[0][1], "step", False, step)]
    for name, a, b in items:
        out += [StampRecord(a, name, False, step),
                StampRecord(b, name, True, step)]
    return out + [StampRecord(items[-1][2], "step", True, step)]


def _synthetic_records():
    """Four steps of one sweep each (ns): step 2 profiled, step 3's first
    stamp lost to the ring. Host spans: each step's ``driver.process_sweep``
    (step 0's ends at 65) with an ``engine.enqueue`` inside."""
    spans, stamps = [], []
    sid = 0
    for step, t in enumerate((0, 100, 200, 300)):
        spans.append(SpanRecord(sid, "driver.process_sweep", t,
                                t + (65 if step == 0 else 90), None,
                                step, 1, step == 2))
        spans.append(SpanRecord(sid + 1, "engine.enqueue", t + 5, t + 25, sid,
                                step, 0, step == 2))
        sid += 2
    stamps += _stamps(0, ("copy.in", 10, 12), ("front", 12, 30),
                      ("odometry", 40, 60), ("tail", 60, 70))
    stamps += _stamps(1, ("copy.in", 110, 112), ("front", 112, 130),
                      ("mapping.gn", 130, 180), ("surround", 185, 195))
    stamps += _stamps(2, ("front", 210, 230), ("odometry", 230, 260))
    stamps += _stamps(3, ("front", 310, 330))[1:]     # lost its first stamp
    return {"spans": spans, "stamps": stamps, "lost": 1,
            "clock_error_ns": 7.0, "counters": {}, "snapshots": []}


def test_summary_arithmetic():
    """Layers, gaps and their causes on hand-made records: step 0 runs to
    step 1's first stamp, step 1 (the next step is profiled) to its own
    last stamp; the profiled step and the step whose first stamp was lost
    are left out."""
    rec = _synthetic_records()
    s = profiling.summary(rec)
    assert s["steps"] == 2 and s["unstamped_steps"] == 1
    assert s["profiled_steps"] == 1 and s["lost"] == 1
    ms = 1e-6 / 2                       # ns a step, in ms a step
    assert s["layer_ms_per_step"] == pytest.approx({
        "copies": 4 * ms, "front": 36 * ms, "odometry": 20 * ms,
        "tail": 10 * ms, "mapping": 50 * ms, "cadence": 10 * ms})
    # Step 0, 10-110: gaps 30-40 and 70-110; step 1, 110-195: 180-185.
    assert s["range_ms_per_step"] == pytest.approx(185 * ms)
    assert s["gap_ms_per_step"] == pytest.approx(55 * ms)
    assert s["gaps"] == 3
    assert s["gap_causes_ms"] == pytest.approx({
        "driver.process_sweep": 15e-6, "no span open": 40e-6})
    assert s["span_ms_per_step"]["engine.enqueue"] == pytest.approx(40 * ms)
    # The window's last step alone; then steps 0 and 1 with 1's span
    # overlapping the excluded interval.
    assert profiling.summary(rec, steps=1)["steps"] == 0
    first = profiling.summary(rec, exclude=(150, 160))
    assert first["steps"] == 1
    assert first["range_ms_per_step"] == pytest.approx(60e-6)   # 10-70


def test_window_counters_between_settles():
    rec = {"snapshots": [(10, {"x": (1, 1)}), (50, {"x": (9, 4)}),
                         (90, {"x": (20, 10)})]}
    assert profiling.window_counters(rec, 20, 80) == {"x": (19, 9)}
    assert profiling.window_counters(rec, 50, 50) == {"x": (0, 0)}
    assert profiling.window_counters(rec, 5, 80) == {}


def test_ring_overflow_is_counted(traced, monkeypatch):
    """A ring of 4 slots written 7 times between reads keeps the last 4
    and counts 3 lost."""
    ring = launches._Ring(CPU, 4)
    monkeypatch.setitem(launches._rings, CPU, ring)
    for _ in range(7):
        profiling.stamp("front")
    rec = profiling.records()
    assert rec["lost"] == 3 and len(rec["stamps"]) == 4


def test_device_trace_holds_the_programs_records(traced, tmp_path):
    """The exporter writes the profiler's events and, beside them, the
    spans and stamped intervals recorded inside it, on the profiler's
    timeline: an operator run inside a span lies inside the span."""
    drv, sweeps = _tiny_driver(2)
    with profiling.device_trace(str(tmp_path)):
        for pts in sweeps:
            drv.process_sweep(pts)
        with profiling.span("anchor"):
            torch.full((3,), 7.0)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    pids = profiling.TRACE_PIDS
    assert {e["args"]["name"] for e in events
            if e.get("name") == "process_name"} >= set(pids)
    names = {e["name"] for e in events if e.get("ph") == "X"
             and e.get("pid") == pids["loam card stamps"]}
    assert {"front", "odometry", "tail"} <= names
    ours = [e for e in events if e.get("pid") == pids["loam host spans"]]
    assert sum(e["name"] == "driver.process_sweep" for e in ours) == 2
    anchor, = [e for e in ours if e["name"] == "anchor"]
    rec = profiling.records()
    assert [s.profiled for s in rec["spans"] if s.name == "anchor"] == [True]
    with profiling.span("unprofiled"):
        pass
    assert not profiling.records()["spans"][-1].profiled
    op = max((e for e in events if e.get("name") == "aten::full"),
             key=lambda e: e["ts"])                # the last, the anchor's
    slack = 50.0                                    # us
    assert anchor["ts"] - slack <= op["ts"]
    assert op["ts"] + op["dur"] <= anchor["ts"] + anchor["dur"] + slack


def _readings(steps: int, seconds: float):
    return types.SimpleNamespace(
        window=types.SimpleNamespace(steps=steps, seconds=seconds),
        launches={}, profile=None, roofline=None)


def test_readers_on_synthetic_readings(monkeypatch, capsys):
    """Each new reader on hand-made records: the window's last steps, the
    profiled one left out; the counters between the settles around it;
    one JSON line printed with the bases; None from a program without
    tracing."""
    rec = _synthetic_records()
    rec["snapshots"] = [(-5, {"odometry.refresh": (0, 0),
                              "mapping.refresh": (0, 0)}),
                        (400, {"odometry.refresh": (16, 8),
                               "mapping.refresh": (10, 10)})]
    fake = types.SimpleNamespace(
        enable=lambda d: None, enabled=lambda: True, records=lambda: rec,
        summary=profiling.summary, window_counters=profiling.window_counters)
    monkeypatch.setattr(program_trace, "_profiling", lambda: fake)
    cell = spec.plan("vlp16-live")
    readers = {m.name: m.read for m in cell.per_layer}
    readers.update({m.name: m.read for m in spec.plan("vlp16-replay-b8")
                    .per_layer})
    r = _readings(steps=4, seconds=400e-9)
    got = {name: readers[name](r) for name in NEW_METRICS}
    ms = 1e-6 / 2
    assert got == pytest.approx({
        "features.device_ms_per_step": 36 * ms,
        "odometry.device_ms_per_step": 20 * ms,
        "mapping.device_ms_per_step": 50 * ms,
        "device.gap_ms_per_step": 55 * ms,
        "driver.enqueue_ms_per_sweep": 40 * ms,
        "driver.cadence_device_ms_per_sweep": 10 * ms,
        "odometry.refresh_lane_use_pct": 50.0,
        "mapping.refresh_lane_use_pct": 100.0})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1
    line = lines[0]["program_trace"]
    assert line["refresh"] == {"odometry.refresh": [16, 8],
                               "mapping.refresh": [10, 10]}
    assert line["steps"] == 2 and line["slice_steps"] == 1
    assert sum(line["gap_cause_shares"].values()) == pytest.approx(1.0)
    assert line["clock_error_ns"] == 7.0
    # The profiled step 2 sits from step 1's end (its span ends at 190,
    # its last stamp at 195) to step 3's start (300): the window's 400 ns
    # less 105 over its 3 other steps.
    assert line["window_ms_per_step_outside_slice"] == pytest.approx(
        295e-6 / 3)
    monkeypatch.setattr(program_trace, "_profiling", lambda: None)
    assert all(readers[name](_readings(4, 1.0)) is None
               for name in NEW_METRICS)


def test_readers_refuse_a_window_the_settles_do_not_bracket(monkeypatch):
    """The window's step spans, counted back from the last, have to be the
    ones between the settles around the window and hold its sweeps: a step
    span begun after the window closed (an eager replay through a step
    span, say), a window that counted fewer sweeps than its spans hold, or
    records without the settles make the reading raise."""
    def reading(rec, steps):
        fake = types.SimpleNamespace(
            enable=lambda d: None, enabled=lambda: True,
            records=lambda: rec, summary=profiling.summary,
            window_counters=profiling.window_counters)
        monkeypatch.setattr(program_trace, "_profiling", lambda: fake)
        return program_trace.read(_readings(steps, 400e-9))

    snaps = [(-5, {"odometry.refresh": (0, 0)}),
             (400, {"odometry.refresh": (4, 2)})]
    rec = {**_synthetic_records(), "snapshots": snaps}
    assert reading(rec, 4)["window_steps"] == 4
    assert [h.step for h in program_trace.window_heads(rec, 4)] == [0, 1, 2, 3]
    late = dict(rec, spans=rec["spans"] + [SpanRecord(
        99, "replay.chunk", 450, 470, None, 4, 1, False)])
    with pytest.raises(RuntimeError, match="bracket 4 spans"):
        reading(late, 4)
    with pytest.raises(RuntimeError, match="bracket 4 spans"):
        reading(rec, 3)
    with pytest.raises(RuntimeError, match="no settles"):
        reading(dict(rec, snapshots=snaps[:1]), 4)


def test_only_a_traced_run_switches_tracing_on():
    """``program_trace.arm``: ``run.py --trace 1`` switches the program's
    tracing on, ``--trace 0`` and any other command do not; planning a
    cell in a ``--trace 0`` run (which loads the readers) leaves it off."""
    run = os.path.join(ROOT, "loam_bench", "run.py")
    args = ["--workload", "vlp16-live", "--seed", "1", "--seconds", "1"]
    assert program_trace.traced_run([run, *args, "--trace", "1"])
    assert not program_trace.traced_run([run, *args, "--trace", "0"])
    assert not program_trace.traced_run([run, *args])
    assert not program_trace.traced_run(["pytest", "--trace", "1"])
    assert not program_trace.arm([run, *args, "--trace", "0"], CPU)
    assert not profiling.enabled()
    try:
        assert program_trace.arm([run, *args, "--trace", "1"], CPU)
        assert profiling.enabled()
    finally:
        profiling.disable()
        profiling.clear()
    code = ("import sys; sys.argv = [sys.argv[1], *sys.argv[2:]]; "
            "from loam_bench import spec; spec.plan('vlp16-live'); "
            "spec.plan('vlp16-replay-b8'); "
            "from loam_velodyne_torch.utils import profiling; "
            "print(profiling.enabled())")
    out = subprocess.run([sys.executable, "-c", code, run, *args, "--trace",
                          "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_benchmark_names_the_new_metrics_in_their_cells():
    """The eight readers are entries of ``BENCHMARK.json`` in the cells the
    tracing measures, and no other cell plans them."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert set(NEW_METRICS) <= set(entries)
    live = {m.name for m in spec.plan("vlp16-live").per_layer}
    replay_cell = {m.name for m in spec.plan("vlp16-replay-b8").per_layer}
    both = set(NEW_METRICS[:4])
    assert both <= live and both <= replay_cell
    assert set(NEW_METRICS[4:6]) <= live - replay_cell
    assert set(NEW_METRICS[6:]) <= replay_cell - live
