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
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

Tensor = torch.Tensor

_on_card: dict = {}              # (device, wrapper) -> () int32
_counting_on_card = 0            # on_card blocks open
_needed: Optional[dict] = None   # needed()'s tally: (device, wrapper) -> ()
_within: list = []               # the predicates of the regions around


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
    return added


def tallying() -> bool:
    """Whether a ``needed`` block is open."""
    return _needed is not None


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
