"""IMU-aided deskew.

Counterpart of ``loam_velodyne_tpu/ops/imu.py``: the host delivers a
fixed-size window of integrated IMU states covering the sweep
(``io/imu.py``); each point's firing time is located in it with a
``searchsorted`` (left side, padding at +inf), the bracketing states
are interpolated, and every point is rotated into the sweep-start IMU
frame. Timestamps are float32 seconds relative to the sweep start.
Everything stays on the window's device: an empty window (count 0) is
a no-op by ``torch.where``, never by a host branch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from loam_velodyne_torch.models.odometry import ImuSweepState
from loam_velodyne_torch.utils import math as lm

Tensor = torch.Tensor

_PI = torch.tensor(math.pi, dtype=torch.float32).item()
_TWO_PI = torch.tensor(2 * math.pi, dtype=torch.float32).item()


class ImuWindow(NamedTuple):
    """Padded window of integrated IMU states around one sweep.

    t:     (K,) float32 seconds relative to the sweep start (ascending,
           padding at +inf)
    rpy:   (K, 3) float32 roll, pitch, yaw
    velo:  (K, 3) float32 world-frame velocity (swapped axes)
    pos:   (K, 3) float32 world-frame position (swapped axes)
    count: () int32 number of real states
    """

    t: Tensor
    rpy: Tensor
    velo: Tensor
    pos: Tensor
    count: Tensor

    @staticmethod
    def empty(capacity: int = 64, device="cuda") -> "ImuWindow":
        z3 = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
        return ImuWindow(
            t=torch.full((capacity,), math.inf, dtype=torch.float32,
                         device=device),
            rpy=z3, velo=z3.clone(), pos=z3.clone(),
            count=torch.zeros((), dtype=torch.int32, device=device))


def _lerp_yaw(y0: Tensor, y1: Tensor, r: Tensor) -> Tensor:
    """Linear yaw interpolation with the +/-pi wrap; r is the weight on y1."""
    y1_adj = torch.where(y0 - y1 > _PI, y1 + _TWO_PI,
                         torch.where(y0 - y1 < -_PI, y1 - _TWO_PI, y1))
    return y0 * (1.0 - r) + y1_adj * r


def _rows(a: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` (any shape) of ``a``: a gather on the device. Indexing
    with a 0-d tensor (``a[idx]``) would read the index back to the host."""
    return a.index_select(0, idx.reshape(-1)).reshape(idx.shape + a.shape[1:])


def interpolate(win: ImuWindow, t: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Interpolated (rpy, velo, pos) at times t (...,): clamped to the
    first / last state outside the history, linear between the
    bracketing states inside it."""
    idx = torch.searchsorted(win.t, t.reshape(-1)).reshape(t.shape)
    last = (win.count - 1).clamp(min=0)
    idx = torch.minimum(idx, last.long())
    prev = (idx - 1).clamp(min=0)

    t_hi = _rows(win.t, idx)
    t_lo = _rows(win.t, prev)
    direct = (idx == 0) | (t_hi < t) | (t_hi - t_lo <= 0)
    # The weight is on the EARLIER state.
    ratio = torch.where(direct, 0.0,
                        (t_hi - t) / torch.clamp(t_hi - t_lo, min=1e-9))

    def mix(a_hi, a_lo):
        return a_hi * (1.0 - ratio[..., None]) + a_lo * ratio[..., None]

    rpy_hi, rpy_lo = _rows(win.rpy, idx), _rows(win.rpy, prev)
    roll = rpy_hi[..., 0] * (1 - ratio) + rpy_lo[..., 0] * ratio
    pitch = rpy_hi[..., 1] * (1 - ratio) + rpy_lo[..., 1] * ratio
    yaw = _lerp_yaw(rpy_hi[..., 2], rpy_lo[..., 2], ratio)
    rpy = torch.stack([roll, pitch, yaw], dim=-1)
    return (rpy, mix(_rows(win.velo, idx), _rows(win.velo, prev)),
            mix(_rows(win.pos, idx), _rows(win.pos, prev)))


def has_data(win: ImuWindow) -> Tensor:
    return win.count > 0


def _at(win: ImuWindow, seconds: float) -> Tuple[Tensor, Tensor, Tensor]:
    return interpolate(win, torch.full((), seconds, dtype=torch.float32,
                                       device=win.t.device))


def project_to_sweep_start(pts: Tensor, rel_seconds: Tensor,
                           win: ImuWindow) -> Tensor:
    """Per-point IMU deskew. pts: (..., 3) swapped-frame points;
    rel_seconds: (...,) firing time from the sweep start. Unchanged
    points when the window is empty."""
    rpy_s, velo_s, pos_s = _at(win, 0.0)
    rpy_c, _, pos_c = interpolate(win, rel_seconds)

    shift = pos_c - pos_s[None, :] - velo_s[None, :] * rel_seconds[..., None]
    # Rotate to the world with the current orientation, then back into
    # the start frame.
    m_cur = lm.rot_zxy_mat(rpy_c[..., 0], rpy_c[..., 1], rpy_c[..., 2])
    p = lm.apply_rot_batched(m_cur, pts) + shift
    m_start_inv = lm.rot_yxz_mat(-rpy_s[2], -rpy_s[1], -rpy_s[0])
    p = lm.apply_rot(m_start_inv, p)
    return torch.where(has_data(win), p, pts)


def sweep_state(win: ImuWindow, scan_period: float) -> ImuSweepState:
    """The per-sweep IMU summary that odometry consumes."""
    rpy_s, velo_s, pos_s = _at(win, 0.0)
    rpy_e, velo_e, pos_e = _at(win, scan_period)

    shift = pos_e - pos_s - velo_s * scan_period
    m_inv = lm.rot_yxz_mat(-rpy_s[2], -rpy_s[1], -rpy_s[0])
    shift_start = lm.apply_rot(m_inv, shift)
    dvelo_start = lm.apply_rot(m_inv, velo_e - velo_s)

    ok = has_data(win)
    return ImuSweepState(
        start_rpy=torch.where(ok, rpy_s, 0.0),
        end_rpy=torch.where(ok, rpy_e, 0.0),
        shift_from_start=torch.where(ok, shift_start, 0.0),
        velo_from_start=torch.where(ok, dvelo_start, 0.0))


def end_attitude(win: ImuWindow, scan_period: float) -> Tuple[Tensor, Tensor]:
    """(rpy at the sweep end, window has data): mapping's roll / pitch
    blend reads the IMU at the sweep end, not its start."""
    return _at(win, scan_period)[0], has_data(win)


def window_at(wins: ImuWindow, i: int) -> ImuWindow:
    """Window i of windows stacked on a leading axis."""
    return ImuWindow(*(a[i] for a in wins))
