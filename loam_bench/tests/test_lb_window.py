"""The window's arithmetic on synthetic timings, and the measurement
path's refusal to run without a card."""

import io
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from loam_bench import run, window
from loam_bench.window import StepResult

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def steps(clock, plan):
    """A step that takes each planned (seconds, sweeps) in turn, timing
    each sweep's hand-in to pose as its whole duration."""
    it = iter(plan)

    def step():
        dt, n = next(it)
        clock.t += dt
        return StepResult(steps=n, lane_sweeps=n,
                          latencies=[dt / max(n, 1)] * n)
    return step


def test_rate_is_all_sweeps_over_the_whole_window():
    c = Clock()
    w = window.measure(steps(c, [(0.5, 8)] * 10), 3.0, clock=c)
    assert w.seconds == pytest.approx(3.0)
    assert w.calls == 6 and w.lane_sweeps == 48
    assert window.rate(w) == pytest.approx(16.0)


def test_the_window_runs_to_the_end_of_the_step_that_passes_it():
    c = Clock()
    w = window.measure(steps(c, [(0.7, 1)] * 10), 2.0, clock=c)
    assert w.seconds == pytest.approx(2.1) and w.lane_sweeps == 3


def test_p95_is_over_every_sweep_and_a_stall_moves_it_and_the_rate():
    c = Clock()
    even = [(0.05, 1)] * 400
    w0 = window.measure(steps(c, even), 10.0, clock=c)
    c = Clock()
    stalled = even[:50] + [(0.5, 1)] * 12 + even[50:]
    w1 = window.measure(steps(c, stalled), 10.0, clock=c)
    assert len(w0.latencies) == w0.lane_sweeps
    assert window.p95(w0.latencies) == pytest.approx(0.05)
    assert window.p95(w1.latencies) == pytest.approx(0.5)
    assert window.rate(w1) < window.rate(w0)


def test_p95_is_nearest_rank():
    assert window.p95(list(range(1, 101))) == 95
    assert window.p95([3.0]) == 3.0
    assert window.p95(list(range(1, 21))) == 19


def test_a_restart_keeps_its_wall_time_in_the_window():
    c = Clock()
    plan = [(0.1, 1)] * 10 + [(0.5, 0)] + [(0.1, 1)] * 10
    w = window.measure(steps(c, plan), 2.5, clock=c)
    assert w.lane_sweeps == 20
    assert w.seconds == pytest.approx(2.5)
    assert window.rate(w) == pytest.approx(20 / 2.5)
    assert len(w.latencies) == 20


def test_reservoir_keeps_a_uniform_sample():
    import numpy as np
    hits = np.zeros(10)
    for s in range(2000):
        r = window.Reservoir(1, np.random.default_rng(s))
        kept = None
        for i in range(10):
            if r.offer() is not None:
                kept = i
        hits[kept] += 1
    assert hits.min() > 140 and hits.max() < 260


def test_the_run_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "vlp16-live", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert out.getvalue() == ""
    assert "CUDA" in err.getvalue()
