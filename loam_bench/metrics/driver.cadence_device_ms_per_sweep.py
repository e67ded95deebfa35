"""driver.cadence_device_ms_per_sweep: the driver's cadence work on the
card a sweep (ms), between the ``surround`` and ``compact`` stamps (the
surround map's build and the archive compaction), over all the window's
sweeps outside the profiled slice (``program_trace.py``)."""

from loam_bench import program_trace


def read(r):
    return program_trace.layer_ms(r, "cadence")
