"""mapping.refresh_lane_use_pct: of the lane-refreshes of mapping's GN
that ran, the share for lanes still running (%), counted on the card
over the window (``mapping.refresh``, ``ops/launches.py::lanes``;
``program_trace.py`` prints the counts)."""

from loam_bench import program_trace


def read(r):
    return program_trace.lane_use_pct(r, "mapping.refresh")
