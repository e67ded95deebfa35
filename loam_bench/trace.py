"""The traced slice of a ``--trace 1`` run: a few steps inside the window
under ``torch.profiler`` (the card's kernels, copies and memsets, and the
host's operators), kept in memory and reduced to:

- the device operations a step, their union on the device timeline
  (``busy_s``) against the slice's wall time (``window_s``), the part of
  the slice in which the profiler flushed its event buffers
  (``profiler_s``), and the wall time of as many steps just before the
  slice, unprofiled (``unprofiled_s`` over ``unprofiled_steps``): under
  the profiler the device intervals of a graphed step add up to more
  than an unprofiled step's whole wall time, so the slice shows where
  the time goes but not the device's idle share;
- ``breakdown``: the device operations that took the most time, by
  name, and the longest gaps between device operations, each named by
  the innermost host operation open at its start.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from loam_bench.window import StepResult

TOP = 10
# The profiler's own pause to copy its event buffers off the card.
PROFILER_FLUSH = "Buffer Flush"


def union(spans: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(length of the union of [start, end) spans, the gaps between its
    pieces as (start, length)); a frozen copy of the port's
    ``tools/profile_step.py::device_activity`` with the gaps kept."""
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b in sorted(spans):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a - cur_b))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return busy, gaps


def reduce(events, wall_s: float, steps: int) -> dict:
    """The slice's numbers from the profiler's events (times in us)."""
    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(span)
    busy_us, gaps = union([(a, b) for a, b, _ in dev])
    flushes = [(a, b) for a, b, name in host if name == PROFILER_FLUSH]
    profiler_us = sum(max(0.0, min(g0 + n, b) - max(g0, a))
                      for g0, n in gaps for a, b in flushes)
    by_name: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host.sort()
    named = []
    for start, length in sorted(gaps, key=lambda g: -g[1])[:TOP]:
        label, best = "host: no operation open", None
        for a, b, name in host:
            if a > start:
                break
            if b > start and (best is None or a >= best):
                best, label = a, "host: " + name
        named.append([label, length / 1e6])
    return {"device_ops": len(dev), "steps": steps, "busy_s": busy_us / 1e6,
            "window_s": wall_s, "profiler_s": profiler_us / 1e6, "device_ops_by_time": [[n, s] for n, s in top],
            "idle_gaps": named}


class Tracer:
    """Wraps a window's step: once ``after_s`` of the window has passed,
    the next ``n_steps`` calls run under the profiler (each call's steps
    counted); the rest run as they are."""

    def __init__(self, step: Callable[[], StepResult], device, after_s: float,
                 n_steps: int, clock: Callable[[], float] = time.perf_counter):
        self.step, self.device = step, torch.device(device)
        self.after_s, self.n_steps, self.clock = after_s, n_steps, clock
        self.t0: Optional[float] = None
        self.prof = None
        self.done = False
        self.steps = 0
        self.recent: List[Tuple[int, float]] = []   # (steps, s) a call

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self) -> StepResult:
        now = self.clock()
        if self.t0 is None:
            self.t0 = now
        if self.prof is None and not self.done and now - self.t0 >= self.after_s:
            self._sync()
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.p0 = self.clock()
        t0 = self.clock()
        r = self.step()
        if self.prof is None and not self.done and r.steps:
            self.recent = (self.recent + [(r.steps, self.clock() - t0)])[
                -self.n_steps:]
        if self.prof is not None:
            self.steps += r.steps
            if self.steps >= self.n_steps:
                self._sync()
                self.wall = self.clock() - self.p0
                self.prof.__exit__(None, None, None)
                self.done = True
                self.events, self.prof = self.prof, None
        return r

    def reduce(self) -> Optional[dict]:
        """The slice's numbers (None when the window ended before it)."""
        if not self.done:
            return None
        out = reduce(self.events.events(), self.wall, self.steps)
        # As many steps as the slice has, just before it (whole calls).
        steps = wall = 0
        for n, dt in reversed(self.recent):
            if steps >= self.steps:
                break
            steps, wall = steps + n, wall + dt
        out["unprofiled_s"], out["unprofiled_steps"] = wall, steps
        return out
