"""device.gap_ms_per_step: the card's time a step that no stamped interval
covers (ms), from one step's first stamp to the next step's first stamp:
the card waiting for the host between graph replays and between steps,
over the window's steps outside the profiled slice
(``program_trace.py``, which prints each gap's host span)."""

from loam_bench import program_trace


def read(r):
    s = program_trace.read(r)
    return None if s is None else s["gap_ms_per_step"]
