"""Offline visualization: trajectory and map renders.

The port's copy of ``loam_velodyne_tpu/eval/viz.py``.

Equivalent of the reference's rviz setup (rviz_cfg/loam_velodyne.rviz +
launch/loam_velodyne.launch:24-26), which displays /laser_cloud_surround,
the registered cloud and the odometry TF tree live. Offline-first here:
render the trajectory and surround map to PNG (matplotlib) so runs are
inspectable without a GUI stack.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(positions: np.ndarray, out_path: str,
                    gt: Optional[np.ndarray] = None,
                    title: str = "LOAM trajectory") -> None:
    """Top-down (z fwd, x left) + height profile. positions: (K, 3) in
    the LOAM camera frame."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    positions = np.asarray(positions)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
    ax1.plot(positions[:, 2], positions[:, 0], "-o", ms=2.5, lw=1.2,
             color="#3b6fb6", label="estimate")
    if gt is not None:
        ax1.plot(gt[:, 2], gt[:, 0], "--", lw=1.2, color="#777777",
                 label="ground truth")
    ax1.set_xlabel("forward z [m]")
    ax1.set_ylabel("left x [m]")
    ax1.set_title(title)
    ax1.axis("equal")
    ax1.legend(loc="best", fontsize=8)

    t = np.arange(len(positions))
    ax2.plot(t, positions[:, 1], lw=1.2, color="#3b6fb6", label="estimate")
    if gt is not None:
        ax2.plot(np.arange(len(gt)), gt[:, 1], "--", lw=1.2,
                 color="#777777", label="ground truth")
    ax2.set_xlabel("sweep")
    ax2.set_ylabel("height y [m]")
    ax2.set_title("height profile")
    ax2.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)


def plot_map(map_xyz: np.ndarray, out_path: str,
             trajectory: Optional[np.ndarray] = None,
             max_points: int = 60000,
             title: str = "surround map") -> None:
    """Top-down scatter of the surround map, colored by height."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(map_xyz)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(pts[:, 2], pts[:, 0], c=pts[:, 1], s=0.5,
                    cmap="viridis", alpha=0.6)
    if trajectory is not None and len(trajectory):
        ax.plot(trajectory[:, 2], trajectory[:, 0], "-", lw=1.5,
                color="#d23f3f", label="trajectory")
        ax.legend(loc="best", fontsize=8)
    fig.colorbar(sc, ax=ax, label="height y [m]", shrink=0.8)
    ax.set_xlabel("forward z [m]")
    ax.set_ylabel("left x [m]")
    ax.set_title(title)
    ax.axis("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
