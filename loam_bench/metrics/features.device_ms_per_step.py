"""features.device_ms_per_step: the front end's device time a step (ms):
ingest with K1, the ring sort, features with K2 and the voxel grid,
between the ``front`` stamps on the card (``engine.front``), over the
window's steps outside the profiled slice (``program_trace.py``)."""

from loam_bench import program_trace


def read(r):
    return program_trace.layer_ms(r, "front")
