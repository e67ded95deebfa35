"""odometry.device_ms_per_step: odometry's device time a step (ms), its GN
with K3 included, between the ``odometry`` stamps on the card
(``odometry.step``), over the window's steps outside the profiled slice
(``program_trace.py``)."""

from loam_bench import program_trace


def read(r):
    return program_trace.layer_ms(r, "odometry")
