"""Host-side IMU tracking: gravity removal and dead-reckoning integration.

Counterpart of ``loam_velodyne_tpu/io/imu.py``: per sample, the
acceleration is swapped into the camera-style frame, gravity is removed
with the orientation, the result is rotated to the world and integrated
into velocity and position, in a bounded history. Rates are O(100 Hz),
so this stays numpy float64 on the host; ``window_for_sweep`` hands the
device a fixed-size window per sweep (``ops/imu.py::ImuWindow``), in one
host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch

from loam_velodyne_torch.ops.imu import ImuWindow

GRAVITY = 9.81


def rpy_from_quaternion(qx, qy, qz, qw):
    """Quaternion -> fixed-axis roll/pitch/yaw (tf getRPY convention)."""
    roll = np.arctan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    pitch = np.arcsin(np.clip(2 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return roll, pitch, yaw


def _rotate_zxy(v, az, ax, ay):
    """numpy rotateZXY (Rz then Rx then Ry), matching utils.math."""
    c, s = np.cos(az), np.sin(az)
    v = np.array([c * v[0] - s * v[1], s * v[0] + c * v[1], v[2]])
    c, s = np.cos(ax), np.sin(ax)
    v = np.array([v[0], c * v[1] - s * v[2], s * v[1] + c * v[2]])
    c, s = np.cos(ay), np.sin(ay)
    return np.array([c * v[0] + s * v[2], v[1], c * v[2] - s * v[0]])


class ImuTracker:
    """Bounded IMU state history with world-frame integration."""

    def __init__(self, history: int = 200):
        self.history = history
        self.stamps: list[float] = []
        self.rpy: list[np.ndarray] = []
        self.velo: list[np.ndarray] = []
        self.pos: list[np.ndarray] = []

    def push_raw(self, stamp: float, quat_xyzw, linear_acc_xyz) -> None:
        """Feed one sensor-frame IMU sample (ROS axis conventions:
        x forward, y left, z up; quaternion xyzw)."""
        roll, pitch, yaw = rpy_from_quaternion(*quat_xyzw)
        ax_, ay_, az_ = linear_acc_xyz
        # swap into camera-style axes + remove gravity
        acc = np.array([
            ay_ - np.sin(roll) * np.cos(pitch) * GRAVITY,
            az_ - np.cos(roll) * np.cos(pitch) * GRAVITY,
            ax_ + np.sin(pitch) * GRAVITY,
        ])
        self.push_state(stamp, (roll, pitch, yaw), acc)

    def push_state(self, stamp: float, rpy, acc_swapped) -> None:
        """Feed a sample whose acceleration is already in swapped axes,
        gravity-free."""
        acc_world = _rotate_zxy(np.asarray(acc_swapped, np.float64),
                                rpy[0], rpy[1], rpy[2])
        if self.stamps:
            dt = stamp - self.stamps[-1]
            pos = (self.pos[-1] + self.velo[-1] * dt
                   + 0.5 * acc_world * dt * dt)
            velo = self.velo[-1] + acc_world * dt
        else:
            pos = np.zeros(3)
            velo = np.zeros(3)
        self.stamps.append(float(stamp))
        self.rpy.append(np.asarray(rpy, np.float64))
        self.velo.append(velo)
        self.pos.append(pos)
        if len(self.stamps) > self.history:
            for buf in (self.stamps, self.rpy, self.velo, self.pos):
                del buf[0]

    def window_for_sweep(self, sweep_start: float, capacity: int = 64,
                         device="cuda") -> ImuWindow:
        """Fixed-size window on ``device``, times relative to
        sweep_start: the last state at or before the sweep start (for
        clamping) and everything after, padded with +inf times."""
        # One float32 block: t (K), rpy, velo, pos (K, 3) each, count.
        block = np.zeros((10 * capacity + 1,), np.float32)
        block[:capacity] = np.inf
        n = 0
        if self.stamps:
            stamps = np.asarray(self.stamps)
            first = int(np.searchsorted(stamps, sweep_start, side="right"))
            sel = slice(max(first - 1, 0), max(first - 1, 0) + capacity)
            t = (stamps[sel] - sweep_start).astype(np.float32)
            n = len(t)
            block[:n] = t
            for j, rows in enumerate((self.rpy, self.velo, self.pos)):
                at = capacity * (1 + 3 * j)
                block[at:at + 3 * n] = np.asarray(
                    np.asarray(rows)[sel], np.float32).reshape(-1)
            block[-1] = n
        d = torch.from_numpy(block).to(device, non_blocking=True)
        k = capacity
        return ImuWindow(t=d[:k], rpy=d[k:4 * k].view(k, 3),
                         velo=d[4 * k:7 * k].view(k, 3),
                         pos=d[7 * k:10 * k].view(k, 3),
                         count=d[-1].to(torch.int32))
