"""mapping.device_ms_per_step: mapping's device time a step (ms), between
the ``mapping.prepare``, ``mapping.gn`` (with K4) and ``mapping.finish``
stamps on the card, over the window's steps outside the profiled slice
(``program_trace.py``); the surround build and the compaction are not
in it (``driver.cadence_device_ms_per_sweep``)."""

from loam_bench import program_trace


def read(r):
    return program_trace.layer_ms(r, "mapping")
