"""driver.host_ms_per_sweep: the driver's own time a sweep (ms), the mean
over the window of a ``process_sweep`` call's wall time less the
driver's ``step`` record for it (the engine's step and the readback):
the pad, the copy to the card, the consume, the surround dispatch and the
archive compaction."""


def read(r):
    host = r.window.host
    return 1e3 * sum(host) / len(host) if host else None
