"""Kernel launch counts, eager and graphed.

Each kernel wrapper counts one launch where it launches its kernel
(``count``). Eagerly that adds one to the wrapper's ``launches``. While
the pipeline's graphs are captured (``on_card``, around
``models/graph.py::capture``) it adds, to the stream being captured, one
to the wrapper's counter on the card (a 0-d int32, ``counter``): each
replay then counts the launches it runs, and a launch inside a
CUDA-graph conditional node (``models/conditional.py``) is counted only
when the card runs the node. ``settle`` adds the card's counters to the
wrappers' ``launches`` and sets them to 0, with one read a card: call it
where the caller synchronises anyway, before reading or zeroing
``launches`` after a graphed run. Any other capture (a graph that times
a kernel alone) holds the kernel's launch only, counted once in Python.

``needed`` is the independent expectation of those counters from an
eager run: inside it, each eager launch also adds, on the card, whether
every conditional region around it (``within``) would run, which is the
launches a graphed run of the same work makes.

The tracing's buffers on the card (``utils/profiling.py`` switches them
on with ``trace``; never made while it is off):

- **Named counters** (``lanes``): in a GN's refresh region
  (``models/conditional.py::run_if_running``), the lanes a refresh runs
  for and those of them still running, as a (2,) int64 on the card:
  under vmap reduced over the lanes by the custom op
  ``loam::lanes_running``'s rule; in a capture counted when the card
  runs the region; eagerly weighted by whether every region around it
  would run (``within``), as ``needed`` tallies launches. ``settle``
  adds them to host totals (``named``) and keeps a snapshot of the
  totals with the host's clock (``snapshots``).
- **The stamp ring** (``stamp``): each stamp writes the card's clock
  and a code into a preallocated ring behind a cursor on the card
  (``csrc/stamp.cu``; on the CPU the same with torch operations and the
  host's clock). The stamp reads no tensor of the lanes, so under vmap
  it runs once, unbatched; in a capture it is a node. ``drain`` reads
  the new entries where the caller has synchronised (``settle`` does
  too) and counts the entries overwritten before they were read.

Both live as long as the process: a graph that holds a stamp or a count
writes their memory on every replay.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from loam_velodyne_torch.ops import cuda_lib

Tensor = torch.Tensor

_on_card: dict = {}              # (device, wrapper) -> () int32
_counting_on_card = 0            # on_card blocks open
_needed: Optional[dict] = None   # needed()'s tally: (device, wrapper) -> ()
_within: list = []               # the predicates of the regions around

_traced: Optional[torch.device] = None  # the device tracing is on for
_rings: dict = {}                # device -> _Ring
_named: dict = {}                # (device, name) -> (2,) int64 on the card
_totals: dict = {}               # name -> [lane-refreshes run, for running]
snapshots: list = []             # (perf_counter_ns, totals) at each settle


def _zero(device: torch.device) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def counter(wrapper: Callable, device: torch.device) -> Tensor:
    """``wrapper``'s launch counter on ``device``, made on first use,
    which must come before a capture (``prepare``)."""
    key = (device, wrapper)
    if key not in _on_card:
        if _capturing(device):
            raise RuntimeError(f"the launch counter of {wrapper.__name__} on "
                               f"{device} is made before a capture "
                               "(launches.prepare)")
        _on_card[key] = _zero(device)
    return _on_card[key]


def prepare(device: torch.device, wrappers) -> None:
    """Before a capture on ``device``: the wrappers' counters there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for wrapper in wrappers:
        counter(wrapper, device)


def count(wrapper: Callable, device: torch.device) -> None:
    """One launch of ``wrapper``'s kernel on ``device``, just made."""
    if _counting_on_card and _capturing(device):
        counter(wrapper, device).add_(1)
        return
    wrapper.launches += 1
    if _needed is not None:
        tally = _needed.get((device, wrapper))
        if tally is None:
            tally = _needed[(device, wrapper)] = _zero(device)
        tally.add_(torch.stack(_within).all().to(torch.int32)
                   if _within else 1)


@contextlib.contextmanager
def on_card(device: torch.device, wrappers):
    """Around a capture whose replays count their launches on the card:
    the wrappers' counters on ``device`` are made on entry, before the
    capture begins."""
    global _counting_on_card
    prepare(device, wrappers)
    _counting_on_card += 1
    try:
        yield
    finally:
        _counting_on_card -= 1


def settle() -> dict:
    """Add the card's counters to the wrappers' ``launches`` and set them
    to 0. Returns the launches added, by wrapper name."""
    added: dict = {}
    for device in {d for d, _ in _on_card}:
        keys = [k for k in _on_card if k[0] == device]
        values = torch.stack([_on_card[k] for k in keys]).tolist()
        for (_, wrapper), n in zip(keys, values):
            wrapper.launches += n
            added[wrapper.__name__] = added.get(wrapper.__name__, 0) + n
            _on_card[(device, wrapper)].zero_()
    named_settle()
    drain()
    return added


def tallying() -> bool:
    """Whether the eager regions give their predicates to ``within``: a
    ``needed`` block is open, or the tracing's counters are on."""
    return _needed is not None or _traced is not None


@contextlib.contextmanager
def needed():
    """Inside the block, each eager launch adds to a tally on its device
    whether every region around it would run. Yields a function that
    returns the tally by wrapper name (one read from each device): the
    launches a graphed run of the block's work makes."""
    global _needed
    outer, table = _needed, {}
    _needed = table

    def tally() -> dict:
        out: dict = {}
        for (_, wrapper), t in table.items():
            out[wrapper.__name__] = out.get(wrapper.__name__, 0) + int(t)
        return out

    try:
        yield tally
    finally:
        _needed = outer


@contextlib.contextmanager
def within(pred: Tensor):
    """Inside a ``needed`` block: the launches in this block run only
    where the 0-d bool ``pred`` holds (a conditional region's predicate,
    computed on the card)."""
    _within.append(pred)
    try:
        yield
    finally:
        _within.pop()


class _Ring:
    """One device's stamp ring: ``buf`` (capacity, 2) int64 of (clock,
    code), ``cursor`` the stamps ever written; on the host the entries
    read so far and the count overwritten before they were read."""

    def __init__(self, device: torch.device, capacity: int):
        self.buf = torch.zeros((capacity, 2), dtype=torch.int64, device=device)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=device)
        self.read = 0
        self.lost = 0
        self.entries: list = []


def trace(device: torch.device, names, capacity: int) -> None:
    """Switch the tracing's buffers on for ``device``: its stamp ring and
    the named counters ``names`` (made once, before any capture)."""
    global _traced
    device = torch.device(device)
    if _capturing(device):
        raise RuntimeError("tracing is switched on before a capture")
    if device not in _rings:
        _rings[device] = _Ring(device, capacity)
    for name in names:
        if (device, name) not in _named:
            _named[(device, name)] = torch.zeros((2,), dtype=torch.int64,
                                                 device=device)
        _totals.setdefault(name, [0, 0])
    _traced = device


def untrace() -> None:
    """Switch the tracing's buffers off (their memory stays)."""
    global _traced
    _traced = None


def stamp(device: torch.device, code: int) -> None:
    """One stamp of ``code`` on ``device``'s ring: on the card a one-thread
    kernel on the current stream (a node in a capture); on the CPU the
    host's clock, written by torch operations at once."""
    ring = _rings[device]
    if device.type == "cuda":
        cuda_lib.stamp(ring.buf, ring.cursor, code)
        return
    i = int(ring.cursor[0]) % ring.buf.shape[0]
    ring.buf[i] = torch.tensor([time.perf_counter_ns(), code])
    ring.cursor.add_(1)


def _lanes_running(done: Tensor) -> Tensor:
    return torch.stack([torch.ones_like(done, dtype=torch.int64),
                        (~done).to(torch.int64)])


def _lanes_running_rule(info, in_dims, done):
    """Under vmap: the lanes and the lanes still running, unbatched."""
    if in_dims[0] is None:
        return _lanes_running(done), None
    running = (~done).sum(dtype=torch.int64)
    return torch.stack([torch.full_like(running, done.shape[in_dims[0]]),
                        running]), None


_lanes_running_op = torch.library.custom_op(
    "loam::lanes_running", _lanes_running, mutates_args=(),
    schema="(Tensor done) -> Tensor")
_lanes_running_op.register_vmap(_lanes_running_rule)


def lanes(name: Optional[str], done: Tensor) -> None:
    """Count a refresh region ``name`` of a GN whose lanes have stopped
    where ``done`` holds: its lanes and its running lanes. Nothing unless
    the tracing is on for ``done``'s device."""
    if name is None or _traced is None or done.device != _traced:
        return
    counter = _named.get((_traced, name))
    if counter is None:
        raise RuntimeError(f"no tracing counter {name!r}: the counters are "
                           "named when tracing is switched on")
    value = _lanes_running_op(done)
    if _within:
        value = value * torch.stack(_within).all().to(torch.int64)
    counter.add_(value)


def named_settle() -> None:
    """Add the named counters to their host totals and set them to 0,
    with one read a card; keep a snapshot of the totals."""
    for device in {d for d, _ in _named}:
        keys = [k for k in _named if k[0] == device]
        values = torch.stack([_named[k] for k in keys]).tolist()
        for (_, name), (run, running) in zip(keys, values):
            _totals[name][0] += run
            _totals[name][1] += running
            _named[(device, name)].zero_()
    if _named:
        snapshots.append((time.perf_counter_ns(),
                          {k: tuple(v) for k, v in _totals.items()}))


@contextlib.contextmanager
def named_unchanged():
    """The named counters as they were before the block (a graph's
    warm-up counts nothing); the caller synchronises inside it."""
    saved = {k: v.clone() for k, v in _named.items()}
    try:
        yield
    finally:
        for k, v in saved.items():
            _named[k].copy_(v)


def named() -> dict:
    """The named counters' host totals: name -> (lane-refreshes run,
    lane-refreshes for running lanes)."""
    return {k: tuple(v) for k, v in _totals.items()}


def drain(device: Optional[torch.device] = None) -> np.ndarray:
    """Read the stamps written since the last read (every ring, or
    ``device``'s): call where the caller has synchronised. Returns the
    new entries, (n, 2) int64 (clock, code), in the order they were
    written; entries overwritten before this read are counted in the
    ring's ``lost``."""
    new = []
    for dev, ring in _rings.items():
        if device is not None and dev != device:
            continue
        n = int(ring.cursor[0])
        cap = ring.buf.shape[0]
        lost = max(0, n - ring.read - cap)
        start = ring.read + lost
        count = n - start
        if count <= 0:
            continue
        lo = start % cap
        first = min(count, cap - lo)
        parts = [ring.buf[lo:lo + first]]
        if count > first:
            parts.append(ring.buf[:count - first])
        got = torch.cat(parts).cpu().numpy()
        ring.entries.append(got)
        ring.lost += lost
        ring.read = n
        new.append(got)
    return np.concatenate(new) if new else np.zeros((0, 2), np.int64)


def entries(device: torch.device) -> tuple:
    """(every entry read from ``device``'s ring, (n, 2), the count lost)."""
    ring = _rings.get(torch.device(device))
    if ring is None or not ring.entries:
        return np.zeros((0, 2), np.int64), 0 if ring is None else ring.lost
    return np.concatenate(ring.entries), ring.lost


def forget() -> None:
    """Drop what the host has read (the entries, the lost count, the
    counters' totals and snapshots); the card's buffers stay."""
    for ring in _rings.values():
        ring.entries, ring.lost = [], 0
    for name in _totals:
        _totals[name] = [0, 0]
    snapshots.clear()
