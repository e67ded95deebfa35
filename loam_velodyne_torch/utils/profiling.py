"""Metrics, tracing and device traces.

Counterpart of ``loam_velodyne_tpu/utils/profiling.py``: ``Metrics`` is
the host-side registry of counters and timings that the driver feeds
(the same class); ``device_trace`` records a ``torch.profiler`` trace
of everything inside it (host operators and, on a card, its kernels)
and writes it as a Chrome trace, viewable in Perfetto, with the
program's own spans and stamps on the same timeline.

**Tracing**, the port's own measurement, is off by default and decided
per process before any graph is captured: ``enable(device)``,
``disable()``, ``clear()``, ``records()``.

- **Spans** (``span(name)``): host intervals on ``time.perf_counter_ns``
  with their parent and the step they belong to. A span opened with
  ``step=True`` outside any step begins a step (a sweep, or a call of
  ``steps`` sweeps of every lane), and every span inside it shares its
  id. A span opened under an active ``torch.profiler`` session is
  marked ``profiled``. It is not a ``record_function`` range: the
  profiler projects such a range onto the card's timeline as a device
  event (``gpu_user_annotation``) as long as the work it launched, which
  a reading of the trace's device events counts as the card's work;
  ``device_trace`` places the spans on the profiler's timeline itself.
  A span always times itself (the driver's ``step_times`` and
  ``live_events`` are views of its spans); it is kept in the records
  only while tracing is on.
- **Stamps** (``stamp``, ``stamps``, ``stamped``): the card's clock and
  a name into a ring on the card (``ops/launches.py``,
  ``csrc/stamp.cu``): eagerly when the card reaches the stamp in its
  stream, in a captured graph on each replay (inside a conditional
  node only when the card runs it), under vmap once for all lanes. The
  layer functions stamp their start and end (``STAMPS``), and each step
  is bracketed by a ``step`` stamp that carries its id, so every stamp
  between them belongs to it. The ring is read where the caller syncs
  anyway (the driver's readback, ``launches.settle``, ``records``). The
  card's clock is mapped onto ``perf_counter_ns`` by calibration when
  tracing is switched on and at each ``records``; the records carry the
  calibration's error bound.
- **Counters**: the GN refresh regions' lane counts
  (``launches.lanes``), named in ``COUNTERS``.

When tracing is off, a stamp and a count are one flag check: nothing is
dispatched, and no graph captured then holds a node that tracing adds.

``summary(records)`` is arithmetic on records (testable anywhere): each
step's device time by layer, the device's gaps (from one step's first
stamp to the next step's first stamp, every interval no stamped interval
covers) and the innermost host span open at each gap's start.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from loam_velodyne_torch.ops import launches


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


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

# Stamp names, and the layer each interval's time goes to. ``step``
# brackets a step; ``calibrate`` serves the clock mapping only.
STAMPS = ("step", "front", "odometry", "mapping.prepare", "mapping.gn",
          "mapping.finish", "tail", "copy.in", "copy.slots", "copy.out",
          "surround", "compact", "calibrate")
LAYERS = {"front": "front", "odometry": "odometry",
          "mapping.prepare": "mapping", "mapping.gn": "mapping",
          "mapping.finish": "mapping", "tail": "tail",
          "copy.in": "copies", "copy.slots": "copies", "copy.out": "copies",
          "surround": "cadence", "compact": "cadence"}
COUNTERS = ("odometry.refresh", "mapping.refresh")
RING_CAPACITY = 1 << 20
COLLECT_EVERY = 256
CALIBRATION_ROUNDS = 16
_INDEX = {name: i for i, name in enumerate(STAMPS)}


class SpanRecord(NamedTuple):
    id: int
    name: str
    t0: int                  # perf_counter_ns
    t1: int
    parent: Optional[int]
    step: Optional[int]
    steps: int               # sweeps of every lane the step holds (its
    #                          opening span only; 0 for the others)
    profiled: bool


class StampRecord(NamedTuple):
    t: float                 # the card's clock mapped to perf_counter_ns
    name: str
    end: bool
    step: Optional[int]


_on = False
_device: Optional[torch.device] = None
_spans: List[SpanRecord] = []
_open: list = []              # the Spans open, innermost last
_ids = [0, 0]                 # the next span id, the next step id
_calibrations: list = []      # (card clock, offset to the host, error), ns
_collects = [0]               # collect() calls


def _code(name: str, end: bool, aux: int = 0) -> int:
    return (aux << 8) | (_INDEX[name] << 1) | int(end)


def _decode(code: int) -> Tuple[str, bool, int]:
    return STAMPS[(code >> 1) & 0x7F], bool(code & 1), code >> 8


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def enabled() -> bool:
    return _on


def enable(device) -> None:
    """Switch tracing on for ``device``, before any graph is captured:
    its stamp ring and counters are made, and the clocks calibrated."""
    global _on, _device
    _device = _card(device)
    launches.trace(_device, COUNTERS, RING_CAPACITY)
    _on = True
    _calibrate()


def disable() -> None:
    """Switch tracing off. Graphs captured while it was on keep their
    stamps and counts."""
    global _on
    _on = False
    launches.untrace()


def clear() -> None:
    """Drop every record so far (spans, stamps, counter totals); the
    calibrations stay."""
    if _device is not None:
        _sync(_device)
        launches.named_settle()
        launches.drain(_device)
    launches.forget()
    _spans.clear()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Span:
    """A host interval (see the module docstring): ``t0`` / ``t1`` in
    ``perf_counter_ns``, ``seconds`` between them."""

    __slots__ = ("name", "step", "steps", "t0", "t1", "_rec", "_id",
                 "_parent", "_step_id", "_opens", "_profiled")

    def __init__(self, name: str, step: bool, steps: int):
        self.name, self.step, self.steps = name, step, steps
        self.t0 = self.t1 = 0
        self._rec = False

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter_ns()
        if _on:
            self._rec = True
            outer = _open[-1] if _open else None
            self._id = _ids[0]
            _ids[0] += 1
            self._parent = None if outer is None else outer._id
            self._step_id = None if outer is None else outer._step_id
            self._opens = self.step and self._step_id is None
            if self._opens:
                self._step_id = _ids[1]
                _ids[1] += 1
                stamp("step", aux=self._step_id)
            self._profiled = torch.autograd._profiler_enabled()
            _open.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec:
            if self._opens:
                stamp("step", end=True, aux=self._step_id)
            _open.remove(self)
        self.t1 = time.perf_counter_ns()
        if self._rec:
            _spans.append(SpanRecord(
                self._id, self.name, self.t0, self.t1, self._parent,
                self._step_id, self.steps if self._opens else 0,
                self._profiled))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span(name: str, step: bool = False, steps: int = 1) -> Span:
    """A host span (a context manager). ``step``: it begins a step of
    ``steps`` sweeps of every lane unless one is open."""
    return Span(name, step, steps)


def stamp(name: str, like=None, end: bool = False, aux: int = 0) -> None:
    """One stamp of ``name`` (its start, or ``end``) on the traced card,
    on its current stream; nothing unless tracing is on and ``like`` (a
    tensor of the work or its device, when given) is on the traced
    device."""
    if not _on or (like is not None
                   and getattr(like, "device", like) != _device):
        return
    launches.stamp(_device, _code(name, end, aux))


class _Stamps:
    __slots__ = ("name", "like")

    def __init__(self, name: str, like):
        self.name, self.like = name, like

    def __enter__(self) -> None:
        stamp(self.name, self.like)

    def __exit__(self, *exc) -> bool:
        stamp(self.name, self.like, end=True)
        return False


_OFF = contextlib.nullcontext()


def stamps(name: str, like=None):
    """Stamp the start and the end of the block (a context manager; a
    shared empty one while tracing is off)."""
    return _Stamps(name, like) if _on else _OFF


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (tuple, list)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def stamped(name: str):
    """Decorate a layer function: its start and end stamped as ``name``
    on the device of its first tensor argument."""
    def wrap(fn):
        @functools.wraps(fn)
        def layer(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with stamps(name, _first_tensor(args)):
                return fn(*args, **kwargs)
        return layer
    return wrap


def collect() -> None:
    """Read the stamps written so far, at every ``COLLECT_EVERY``-th call:
    call where the caller has just waited for the card (after the
    driver's readback). The ring holds ``RING_CAPACITY`` stamps (~30 a
    sweep), so reading it that rarely loses none and keeps its reads off
    most sweeps; a read is the span ``trace.collect``, so a device gap
    it opens is put down to the tracing itself."""
    if _on:
        _collects[0] += 1
        if _collects[0] % COLLECT_EVERY == 0:
            with span("trace.collect"):
                launches.drain(_device)


def _calibrate() -> None:
    """One calibration of the card's clock against ``perf_counter_ns``:
    stamps bracketed by host clock reads around a launch and a wait; the
    offset is the intersection of the brackets."""
    dev = _device
    now = time.perf_counter_ns()
    if dev.type != "cuda":
        _calibrations.append((now, 0.0, 0.0))      # one clock
        return
    _sync(dev)
    launches.drain(dev)
    brackets = []
    for _ in range(CALIBRATION_ROUNDS):
        h0 = time.perf_counter_ns()
        launches.stamp(dev, _code("calibrate", False))
        torch.cuda.synchronize(dev)
        brackets.append((h0, time.perf_counter_ns()))
    got = launches.drain(dev)
    marks = [int(t) for t, c in got if c == _code("calibrate", False)]
    marks = marks[-len(brackets):]
    lo = max(h0 - g for (h0, _), g in zip(brackets, marks))
    hi = min(h1 - g for (_, h1), g in zip(brackets, marks))
    if lo <= hi:
        offset, err = (lo + hi) / 2, (hi - lo) / 2
    else:                                # the brackets disagree: widen
        offset, err = (lo + hi) / 2, (lo - hi) / 2
    _calibrations.append((marks[len(marks) // 2], offset, err))


def _to_host(times, cals) -> List[float]:
    """The card's clock readings on ``perf_counter_ns``: the offsets of
    the calibrations around each reading, interpolated (linear drift),
    extrapolated along the nearest pair outside them."""
    cals = sorted(cals)
    if not cals:
        return [float(t) for t in times]
    if len(cals) == 1:
        return [t + cals[0][1] for t in times]
    gs = [c[0] for c in cals]
    out = []
    for t in times:
        i = min(max(bisect.bisect_left(gs, t), 1), len(cals) - 1)
        (g0, o0, _), (g1, o1, _) = cals[i - 1], cals[i]
        f = (t - g0) / (g1 - g0) if g1 != g0 else 0.0
        out.append(t + o0 + f * (o1 - o0))
    return out


def records() -> dict:
    """Every record so far (waits for the traced card, reads its ring and
    calibrates once more): ``spans`` (``SpanRecord``), ``stamps``
    (``StampRecord``, on the host's clock, each with its step), the
    named counters' totals (``counters``) and snapshots (``snapshots``,
    each at a ``launches.settle``), the stamps lost to the ring's
    overflow (``lost``) and the clock mapping's error bound in ns
    (``clock_error_ns``)."""
    if _device is None:
        return {"device": None, "spans": list(_spans), "stamps": [],
                "counters": {}, "snapshots": [], "lost": 0,
                "clock_error_ns": None}
    _sync(_device)
    launches.drain(_device)
    if _on:
        _calibrate()
    raw, lost = launches.entries(_device)
    times = _to_host([int(t) for t in raw[:, 0]], _calibrations)
    out, step = [], None
    for t, code in zip(times, raw[:, 1]):
        name, end, aux = _decode(int(code))
        if name == "calibrate":
            continue
        if name == "step" and not end:
            step = aux
        out.append(StampRecord(t, name, end, step))
        if name == "step" and end:
            step = None
    return {"device": str(_device), "spans": sorted(_spans),
            "stamps": out, "counters": launches.named(),
            "snapshots": list(launches.snapshots), "lost": lost,
            "clock_error_ns": max(c[2] for c in _calibrations)}


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------

def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intervals(stamps) -> List[Tuple[str, float, float, Optional[int]]]:
    """The stamped intervals (name, start, end, step of the start), each
    start paired with the next end of its name; a start without an end
    (lost to the ring) is dropped."""
    opened: dict = defaultdict(list)
    out = []
    for s in stamps:
        if s.name == "step":
            continue
        if not s.end:
            opened[s.name].append(s)
        elif opened[s.name]:
            b = opened[s.name].pop()
            out.append((s.name, b.t, s.t, b.step))
    return out


def _open_at(host: list, starts: list, t: float) -> str:
    """The innermost span of ``host`` (sorted by start) open at ``t``:
    the latest started that has not ended; spans nest, so the walk back
    stops at a top-level span that ended before ``t``."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s = host[i]
        if s.t1 > t:
            return s.name
        if s.parent is None:
            break
    return "no span open"


def summary(rec: dict, exclude: Optional[Tuple[float, float]] = None,
            steps: Optional[int] = None) -> dict:
    """Device time by layer, device gaps and their host causes over the
    steps of ``rec`` (``records()``): the last steps holding ``steps``
    sweeps of every lane (all of them when None), less the steps whose
    spans were profiled or overlap ``exclude`` ((t0, t1) on
    ``perf_counter_ns``) and the steps whose first stamp was lost. A
    step's device range runs from its first stamp to the next step's
    first stamp when that step is kept too, else to its own last stamp.
    Per-step values are over the kept steps' sweeps of every lane."""
    spans = rec["spans"]
    heads = sorted((s for s in spans if s.steps), key=lambda s: s.t0)
    if steps is not None:
        chosen, n = [], 0
        for s in reversed(heads):
            if n >= steps:
                break
            chosen.append(s)
            n += s.steps
        heads_w = set(s.step for s in chosen)
    else:
        heads_w = set(s.step for s in heads)
    profiled = {s.step for s in spans if s.profiled}
    first = {s.step: s.t for s in rec["stamps"] if s.name == "step"
             and not s.end}
    last = {s.step: s.t for s in rec["stamps"] if s.name == "step" and s.end}

    def kept(h) -> bool:
        return (h.step in heads_w and h.step not in profiled
                and h.step in first and h.step in last
                and (exclude is None or h.t1 <= exclude[0]
                     or h.t0 >= exclude[1]))

    keep = [h for h in heads if kept(h)]
    unstamped = sum(1 for h in heads if h.step in heads_w
                    and h.step not in profiled
                    and (h.step not in first or h.step not in last))
    order = [h.step for h in heads]
    ranges = {}
    for h in keep:
        i = order.index(h.step)
        nxt = heads[i + 1] if i + 1 < len(heads) else None
        end = (first[nxt.step] if nxt is not None and kept(nxt)
               else last[h.step])
        ranges[h.step] = (first[h.step], end)

    ivs = intervals(rec["stamps"])
    layer_ns: Dict[str, float] = defaultdict(float)
    for name, a, b, step in ivs:
        if step in ranges:
            layer_ns[LAYERS[name]] += b - a
    covered = _union((a, b) for _, a, b, _ in ivs)
    ends = [b for _, b in covered]
    gaps, causes = [], defaultdict(float)
    range_ns = 0.0
    for step, (a, b) in sorted(ranges.items(), key=lambda kv: kv[1]):
        range_ns += b - a
        cur = a
        for c0, c1 in itertools.islice(covered, bisect.bisect_right(ends, a),
                                       None):
            if c0 >= b:
                break
            if c0 > cur:
                gaps.append((cur, c0 - cur))
            cur = max(cur, c1)
        if cur < b:
            gaps.append((cur, b - cur))
    host = sorted(spans, key=lambda s: s.t0)
    starts = [s.t0 for s in host]
    for g0, length in gaps:
        causes[_open_at(host, starts, g0)] += length
    span_ns: Dict[str, float] = defaultdict(float)
    kept_steps = {h.step for h in keep}
    for s in spans:
        if s.step in kept_steps:
            span_ns[s.name] += s.t1 - s.t0
    n = sum(h.steps for h in keep)
    gap_ns = sum(g for _, g in gaps)

    def per(x: float) -> Optional[float]:
        return x / 1e6 / n if n else None

    return {
        "steps": n, "kept_step_spans": len(keep), "unstamped_steps": unstamped,
        "profiled_steps": sum(h.steps for h in heads if h.step in profiled
                              and h.step in heads_w),
        "layer_ms_per_step": {k: per(v) for k, v in sorted(layer_ns.items())},
        "gap_ms_per_step": per(gap_ns),
        "range_ms_per_step": per(range_ns),
        "span_ms_per_step": {k: per(v) for k, v in sorted(span_ns.items())},
        "gap_causes_ms": {k: v / 1e6 for k, v in
                          sorted(causes.items(), key=lambda kv: -kv[1])},
        "gaps": len(gaps), "lost": rec.get("lost", 0),
        "clock_error_ns": rec.get("clock_error_ns"),
    }


def window_counters(rec: dict, t0: float, t1: float) -> dict:
    """The named counters between the last snapshot at or before ``t0``
    and the first at or after ``t1`` (``perf_counter_ns``): name ->
    (run, running); empty when no snapshots bracket the interval."""
    snaps = rec.get("snapshots", [])
    before = [s for s in snaps if s[0] <= t0]
    after = [s for s in snaps if s[0] >= t1]
    if not before or not after:
        return {}
    a, b = before[-1][1], after[0][1]
    return {k: (b[k][0] - a[k][0], b[k][1] - a[k][1]) for k in b if k in a}


# ---------------------------------------------------------------------------
# Device traces
# ---------------------------------------------------------------------------

# Chrome trace processes of the program's records (named by metadata
# events), apart from the profiler's.
TRACE_PIDS = {"loam host spans": 1 << 30, "loam card stamps": (1 << 30) + 1}
_ROWS = sorted(set(LAYERS.values()))


def _chrome_events(rec: dict, span_us: float, stamp_us: float) -> list:
    """The records as Chrome trace events on the profiler's timeline
    (``span_us`` / ``stamp_us`` added to a span's / a stamp's
    ``perf_counter_ns`` / 1e3): the spans on one row of the process
    "loam host spans", the stamped intervals on a row a layer of "loam
    card stamps"."""
    spans, card = TRACE_PIDS["loam host spans"], TRACE_PIDS["loam card stamps"]
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}} for name, pid in TRACE_PIDS.items()]
    out += [{"ph": "M", "name": "thread_name", "pid": card, "tid": i,
             "args": {"name": row}} for i, row in enumerate(_ROWS)]
    for s in rec["spans"]:
        out.append({"ph": "X", "name": s.name, "pid": spans, "tid": 0,
                    "ts": s.t0 / 1e3 + span_us, "dur": (s.t1 - s.t0) / 1e3,
                    "args": {"step": s.step, "parent": s.parent}})
    err_us = (rec["clock_error_ns"] or 0) / 1e3
    for name, a, b, step in intervals(rec["stamps"]):
        out.append({"ph": "X", "name": name, "pid": card,
                    "tid": _ROWS.index(LAYERS[name]),
                    "ts": a / 1e3 + stamp_us, "dur": (b - a) / 1e3,
                    "args": {"step": step, "clock_error_us": err_us}})
    return out


def _stamp_offset_us(events: list, rec: dict, default: float) -> float:
    """Microseconds to add to a stamp's time / 1e3 to land on the
    profiler's own events of the stamp kernels (the same launches, in the
    same order): the median of the differences; ``default`` when the
    counts differ (no card, or stamps outside the profile)."""
    kernels = sorted(e["ts"] for e in events if e.get("ph") == "X"
                     and "stamp_kernel" in str(e.get("name", "")))
    ours = sorted(s.t / 1e3 for s in rec["stamps"])
    if not kernels or len(kernels) != len(ours):
        return default
    diffs = sorted(k - o for k, o in zip(kernels, ours))
    return diffs[len(diffs) // 2]


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the context (CPU operators, and the
    card's kernels and copies when one is present) and write
    ``log_dir/trace.json``; with tracing on, the program's spans (the
    process "loam host spans") and stamped intervals (the process "loam
    card stamps", a row a layer) recorded inside the context join the
    same trace, on the profiler's timeline: the spans by the host's
    clocks (the trace's times are the wall clock less its
    ``baseTimeNanoseconds``), the stamps onto the profiler's own events
    of the stamp kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    t1 = time.perf_counter_ns()
    wall_minus_mono = time.time_ns() - time.perf_counter_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if not _on:
        return
    rec = records()
    rec["spans"] = [s for s in rec["spans"] if t0 <= s.t0 <= t1]
    rec["stamps"] = [s for s in rec["stamps"] if t0 <= s.t <= t1]
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    span_us = (wall_minus_mono - trace.get("baseTimeNanoseconds", 0)) / 1e3
    stamp_us = _stamp_offset_us(events, rec, span_us)
    events += _chrome_events(rec, span_us, stamp_us)
    with open(path, "w") as f:
        json.dump(trace, f)
