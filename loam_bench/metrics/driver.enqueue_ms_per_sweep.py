"""driver.enqueue_ms_per_sweep: the host's time a sweep in the
``engine.enqueue`` span (ms): the engine's call, its slot copies and
graph launches, over the window's sweeps outside the profiled slice
(``program_trace.py``)."""

from loam_bench import program_trace


def read(r):
    s = program_trace.read(r)
    return None if s is None else s["span_ms_per_step"].get("engine.enqueue")
