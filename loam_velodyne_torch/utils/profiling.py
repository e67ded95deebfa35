"""Metrics and device traces.

Counterpart of ``loam_velodyne_tpu/utils/profiling.py``: ``Metrics`` is
the host-side registry of counters and timings that the driver feeds
(the same class); ``device_trace`` records a ``torch.profiler`` trace
of everything inside it (host operators and, on a card, its kernels)
and writes it as a Chrome trace, viewable in Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


class Metrics:
    """Counters + timing histograms for a pipeline run."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.timings: Dict[str, List[float]] = defaultdict(list)

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.timings[name].append(seconds)

    def summary(self) -> Dict:
        out: Dict = {"counters": dict(self.counters), "timings": {}}
        for name, vals in self.timings.items():
            if not vals:
                continue
            v = sorted(vals)
            n = len(v)
            out["timings"][name] = {
                "n": n,
                "mean_ms": 1e3 * sum(v) / n,
                "p50_ms": 1e3 * v[n // 2],
                "p90_ms": 1e3 * v[min(n - 1, int(0.9 * n))],
                "max_ms": 1e3 * v[-1],
            }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the context (CPU operators, and the
    card's kernels and copies when one is present) and write
    ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
