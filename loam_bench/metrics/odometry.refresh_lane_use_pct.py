"""odometry.refresh_lane_use_pct: of the lane-refreshes of odometry's GN
that ran (a refresh region runs for every lane while any lane runs),
the share for lanes still running (%), counted on the card over the
window (``odometry.refresh``, ``ops/launches.py::lanes``;
``program_trace.py`` prints the counts)."""

from loam_bench import program_trace


def read(r):
    return program_trace.lane_use_pct(r, "odometry.refresh")
