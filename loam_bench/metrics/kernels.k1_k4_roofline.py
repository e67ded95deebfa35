"""kernels.k1_k4_roofline: the four kernels' share of their roofline (%),
the sum of each recorded call's least time on an H100 over the sum of its
time alone in a CUDA graph (``roofline.py``), over the calls of a few of
the cell's steps replayed eagerly after the window."""


def read(r):
    f = r.roofline
    return 100.0 * f["bound_ms"] / f["time_ms"] if f and f["time_ms"] else None
