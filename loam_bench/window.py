"""The measured window's arithmetic, apart from the card so that it can be
tested anywhere.

A window is a closed loop: ``step()`` hands the next piece of work to
the system and returns when its poses are on the host; the next goes in
then. The window runs until ``seconds`` have passed at a step's end, and
its length is the time from its start to the end of its last step, so
everything in it (bag and drive restarts, startup sweeps, cadence work,
a stall) is in the rate's denominator.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepResult:
    steps: int = 0               # sweeps of every lane (batched sweeps)
    lane_sweeps: int = 0         # sweeps completed, over all lanes
    latencies: List[float] = dataclasses.field(default_factory=list)
    host: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Window:
    seconds: float
    steps: int
    lane_sweeps: int
    calls: int
    latencies: List[float]       # s, hand-in to pose, every counted sweep
    host: List[float]            # s, the driver's own time a sweep
    durations: List[float] = dataclasses.field(default_factory=list)


def measure(step: Callable[[], StepResult], seconds: float,
            clock: Callable[[], float] = time.perf_counter,
            after: Optional[Callable[[float], None]] = None) -> Window:
    """Run ``step`` in a closed loop for at least ``seconds``; ``after``
    is called with the elapsed time after each step."""
    t0 = clock()
    steps = lane_sweeps = calls = 0
    lat, host, durations = [], [], []
    last = t0
    while True:
        r = step()
        calls += 1
        steps += r.steps
        lane_sweeps += r.lane_sweeps
        lat += r.latencies
        host += r.host
        now = clock()
        durations.append(now - last)
        last = now
        elapsed = now - t0
        if after is not None:
            after(elapsed)
        if elapsed >= seconds:
            break
    return Window(clock() - t0, steps, lane_sweeps, calls, lat, host,
                  durations)


def rate(w: Window) -> float:
    """Sweeps completed over all lanes per second of the whole window."""
    return w.lane_sweeps / w.seconds


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    if not values:
        raise ValueError("no samples")
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Reservoir:
    """A uniform sample of ``k`` of the items offered, from ``rng``:
    ``offer(i)`` says which slot item i takes (None: not kept)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen = k, rng, 0

    def offer(self) -> Optional[int]:
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None
