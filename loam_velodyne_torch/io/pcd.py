"""Minimal PCD (Point Cloud Data) writer/reader.

The port's copy of ``loam_velodyne_tpu/io/pcd.py``.

Fills the role of the reference's PCL cloud messages as an on-disk
interchange format (the reference publishes pcl clouds over ROS,
common.h:52-62; here clouds are exported to files).
Supports ascii and binary PCD v0.7 with x/y/z[/intensity] fields.
"""

from __future__ import annotations

import numpy as np


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
              binary: bool = True) -> None:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    count = len(fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * count)}\n"
        f"TYPE {' '.join(['F'] * count)}\n"
        f"COUNT {' '.join(['1'] * count)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = xyz if intensity is None else np.column_stack(
        [xyz, np.asarray(intensity, np.float32)])
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Returns (xyz (N,3), intensity (N,) or None)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        n = int(header["POINTS"])
        sizes = [int(s) for s in header["SIZE"].split()]
        if any(s != 4 for s in sizes):
            raise ValueError("only 4-byte float PCD fields supported")
        width = len(fields)
        if header["DATA"] == "binary":
            data = np.frombuffer(f.read(4 * width * n), np.float32)
            data = data.reshape(n, width)
        else:
            data = np.loadtxt(f, dtype=np.float32).reshape(n, width)
    ix = [fields.index(k) for k in ("x", "y", "z")]
    xyz = data[:, ix]
    inten = data[:, fields.index("intensity")] if "intensity" in fields else None
    return xyz, inten
