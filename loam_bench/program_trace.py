"""The program's own tracing in a ``--trace 1`` run: the spans, on-card
stamps and counters of ``loam_velodyne_torch/utils/profiling.py``, for
the per-layer metrics ``features.device_ms_per_step``,
``odometry.device_ms_per_step``, ``mapping.device_ms_per_step``,
``device.gap_ms_per_step``, ``driver.enqueue_ms_per_sweep``,
``driver.cadence_device_ms_per_sweep``, ``odometry.refresh_lane_use_pct``
and ``mapping.refresh_lane_use_pct`` (``metrics/<name>.py``).

Switching it on. The program's tracing has to be on before the entry's
set-up captures its graphs, and ``run.py`` has no step there; the
metric readers are loaded before it (``spec.plan``). So importing this
module (each of those readers does) switches the tracing on when the
process is ``loam_bench/run.py`` with ``--trace 1`` (``arm``), and
does nothing in a ``--trace 0`` run, in a test, or with a program that
has no tracing (no ``profiling.enable``), where the readers return
None.

The window. The records hold the whole process. Nothing after the
window opens a step, so the window's steps are the last step spans
(``driver.process_sweep``, ``replay.chunk``) that hold as many sweeps of
every lane as the window counted; the profiled slice's steps (spans
marked ``profiled``) are left out, and with them the profiler's
distortions. That inference is checked (``window_heads``): ``run.py``
settles the launch counters just before the window and just after it,
and nothing else settles them in a run, so the last two snapshots of the
settles bracket the window; the step spans counted back have to be
exactly those between them and hold exactly the window's sweeps, or the
reading raises. The counters are taken between the same two settles.

The reading is made once a run and printed as one JSON line
(``program_trace``): the summary (each layer's device time a step, the
gaps a step and their causes by host span, with the shares), the base of
every ratio (the steps, the counts), the clock mapping's error bound,
the stamps lost to the ring, and the stamped time a step against the
window's seconds a step outside the profiled slice.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import torch


def traced_run(argv) -> bool:
    """Whether ``argv`` (``sys.argv``) is ``loam_bench/run.py`` with
    ``--trace 1``."""
    if not argv:
        return False
    script = os.path.abspath(argv[0])
    if (os.path.basename(script) != "run.py"
            or os.path.basename(os.path.dirname(script)) != "loam_bench"):
        return False
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--trace", type=int, default=0)
    try:
        known, _ = p.parse_known_args(argv[1:])
    except SystemExit:
        return False
    return known.trace == 1


def _profiling():
    try:
        from loam_velodyne_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


def arm(argv, device=None) -> bool:
    """Switch the program's tracing on for ``device`` (the first card)
    when ``argv`` is a traced run; returns whether it did."""
    profiling = _profiling()
    if profiling is None or not traced_run(argv):
        return False
    if device is None:
        if not torch.cuda.is_available():
            return False
        device = torch.device("cuda", 0)
    profiling.enable(device)
    return True


ARMED = arm(sys.argv)


def _slice(heads: list, ends: dict, window_end: float) -> tuple:
    """(host ns, sweeps of every lane) of the profiled slice: from the
    end of the last step before it (its span's end, or its last stamp on
    the card where the caller waits for the card outside the span, as the
    replay's entry does) to the start of the first after it, or to the
    window's end (``perf_counter_ns``) when none follows (the profiler's
    start and stop are in it). ``ends``: each step's last stamp."""
    idx = [i for i, h in enumerate(heads) if h.profiled]
    if not idx:
        return 0, 0
    a, b = idx[0], idx[-1]
    start = (max(heads[a - 1].t1, ends.get(heads[a - 1].step, 0)) if a > 0
             else heads[a].t0)
    end = heads[b + 1].t0 if b + 1 < len(heads) else window_end
    return end - start, sum(heads[i].steps for i in idx)


def window_heads(rec: dict, steps: int) -> list:
    """The window's step spans, by start: the last ones back to ``steps``
    sweeps of every lane, checked against the settles that bracket the
    window (see the module docstring)."""
    heads = sorted((x for x in rec["spans"] if x.steps), key=lambda x: x.t0)
    chosen, n = [], 0
    for h in reversed(heads):
        if n >= steps:
            break
        chosen.insert(0, h)
        n += h.steps
    snaps = rec.get("snapshots", [])
    if len(snaps) < 2:
        raise RuntimeError("no settles bracket the window: its step spans "
                           "cannot be checked")
    t_open, t_close = snaps[-2][0], snaps[-1][0]
    inside = [h for h in heads if t_open <= h.t0 < t_close]
    if n != steps or chosen != inside or chosen[-1].t1 > t_close:
        raise RuntimeError(
            f"the window counted {steps} sweeps of every lane; the step "
            f"spans counted back hold {n} in {len(chosen)} spans, the "
            f"settles around the window bracket {len(inside)} spans")
    return chosen


def read(r) -> Optional[dict]:
    """The run's reading (computed and printed once), or None."""
    if not hasattr(r, "_program_trace"):
        r._program_trace = _read(r)
        if r._program_trace is not None:
            print(json.dumps({"program_trace": r._program_trace}), flush=True)
    return r._program_trace


def _read(r) -> Optional[dict]:
    profiling = _profiling()
    if profiling is None or not profiling.enabled() or not r.window.steps:
        return None
    rec = profiling.records()
    heads = window_heads(rec, r.window.steps)
    s = profiling.summary(rec, steps=r.window.steps)
    if not s["steps"]:
        return None
    # The window opens just before its first step's span.
    ends = {x.step: x.t for x in rec["stamps"] if x.name == "step" and x.end}
    slice_ns, slice_steps = _slice(heads, ends,
                                   heads[0].t0 + 1e9 * r.window.seconds)
    outside = r.window.steps - slice_steps
    window_ms = ((1e9 * r.window.seconds - slice_ns) / 1e6 / outside
                 if outside else None)
    stamped = sum(v for v in s["layer_ms_per_step"].values())
    total = stamped + (s["gap_ms_per_step"] or 0.0)
    causes = s["gap_causes_ms"]
    all_gaps = sum(causes.values())
    s["gap_cause_shares"] = {k: v / all_gaps for k, v in causes.items()} \
        if all_gaps else {}
    s["device_ms_per_step"] = total
    s["window_ms_per_step_outside_slice"] = window_ms
    s["device_over_window"] = total / window_ms if window_ms else None
    s["window_steps"] = r.window.steps
    s["slice_steps"] = slice_steps
    s["refresh"] = profiling.window_counters(rec, heads[0].t0, heads[-1].t1)
    return s


def layer_ms(r, layer: str) -> Optional[float]:
    """A layer's stamped device time a step (0 where the window stamped
    none of it)."""
    s = read(r)
    return None if s is None else s["layer_ms_per_step"].get(layer, 0.0)


def lane_use_pct(r, counter: str) -> Optional[float]:
    """Lane-refreshes for running lanes over lane-refreshes run, in %."""
    s = read(r)
    got = None if s is None else s["refresh"].get(counter)
    return 100.0 * got[1] / got[0] if got and got[0] else None
