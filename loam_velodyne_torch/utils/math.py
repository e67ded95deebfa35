"""Rotation and pose math in LOAM's Euler conventions, as torch ops.

Counterpart of ``loam_velodyne_tpu/utils/math.py``. A pose is a flat
(6,) float32 tensor ``[rot_x, rot_y, rot_z, pos_x, pos_y, pos_z]`` acting
on points as ``p' = R p + t`` with ``R = Ry(ry) Rx(rx) Rz(rz)``.

Matrix products are written as explicit float32 multiply-adds, as in the
JAX package: the point is the exact float32 formula, not a library
matmul whose precision depends on the device's defaults.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

ROT = slice(0, 3)
POS = slice(3, 6)


def identity_pose(device: torch.device | str) -> Tensor:
    return torch.zeros((6,), dtype=torch.float32, device=device)


def make_pose(rot, pos, device: torch.device | str) -> Tensor:
    rot = torch.as_tensor(rot, dtype=torch.float32, device=device).reshape(3)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device).reshape(3)
    return torch.cat([rot, pos])


# ---------------------------------------------------------------------------
# Elementary rotations.
# ---------------------------------------------------------------------------

def _stack3x3(rows) -> Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x_mat(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y_mat(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z_mat(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([[c, -s, z], [s, c, z], [z, z, o]])


def mat3_mul(a: Tensor, b: Tensor) -> Tensor:
    """(...,3,3) @ (...,3,3) as explicit float32 multiply-adds."""
    rows = []
    for i in range(3):
        rows.append([a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
                     + a[..., i, 2] * b[..., 2, j] for j in range(3)])
    return _stack3x3(rows)


def mat3_transpose(m: Tensor) -> Tensor:
    return m.transpose(-1, -2)


def rot_zxy_mat(az: Tensor, ax: Tensor, ay: Tensor) -> Tensor:
    """Matrix of rotateZXY: applies Rz first, then Rx, then Ry."""
    return mat3_mul(rot_y_mat(ay), mat3_mul(rot_x_mat(ax), rot_z_mat(az)))


def rot_yxz_mat(ay: Tensor, ax: Tensor, az: Tensor) -> Tensor:
    """Matrix of rotateYXZ: applies Ry first, then Rx, then Rz."""
    return mat3_mul(rot_z_mat(az), mat3_mul(rot_x_mat(ax), rot_y_mat(ay)))


def pose_rot_mat(pose: Tensor) -> Tensor:
    """R = Ry(ry) Rx(rx) Rz(rz) for a (...,6) pose."""
    r = pose[..., ROT]
    return rot_zxy_mat(r[..., 2], r[..., 0], r[..., 1])


def euler_yxz(m: Tensor) -> Tensor:
    """(rx, ry, rz) with R = Ry(ry) Rx(rx) Rz(rz) from a (...,3,3) matrix."""
    rx = -torch.asin(torch.clamp(m[..., 1, 2], -1.0, 1.0))
    ry = torch.atan2(m[..., 0, 2], m[..., 2, 2])
    rz = torch.atan2(m[..., 1, 0], m[..., 1, 1])
    return torch.stack([rx, ry, rz], -1)


# ---------------------------------------------------------------------------
# Point transforms.
# ---------------------------------------------------------------------------

def apply_rot(m: Tensor, pts: Tensor) -> Tensor:
    """Rotate (...,3) points by one (3,3) matrix."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
    ], dim=-1)


def apply_rot_batched(m: Tensor, pts: Tensor) -> Tensor:
    """Rotate (...,3) points by matching (...,3,3) matrices."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    ], dim=-1)


def pose_transform_points(pose: Tensor, pts: Tensor) -> Tensor:
    """p' = R p + t."""
    return apply_rot(pose_rot_mat(pose), pts) + pose[POS]


def pose_inverse_transform_points(pose: Tensor, pts: Tensor) -> Tensor:
    """p' = R^T (p - t)."""
    return apply_rot(mat3_transpose(pose_rot_mat(pose)), pts - pose[POS])


# ---------------------------------------------------------------------------
# Pose composition.
# ---------------------------------------------------------------------------

def accumulate_rotation(c: Tensor, l: Tensor) -> Tensor:
    """Euler angles of R(c) @ R(l)."""
    rc = rot_zxy_mat(c[2], c[0], c[1])
    rl = rot_zxy_mat(l[2], l[0], l[1])
    return euler_yxz(mat3_mul(rc, rl))


def plugin_imu_rotation(bc: Tensor, bl: Tensor, al: Tensor) -> Tensor:
    """Euler angles of R(bc) @ R(bl)^T @ R(al)."""
    rbc = rot_zxy_mat(bc[2], bc[0], bc[1])
    rbl = rot_zxy_mat(bl[2], bl[0], bl[1])
    ral = rot_zxy_mat(al[2], al[0], al[1])
    return euler_yxz(mat3_mul(mat3_mul(rbc, mat3_transpose(rbl)), ral))


def transform_associate_to_map(transform_sum: Tensor, transform_bef: Tensor,
                               transform_aft: Tensor) -> Tensor:
    """T_tobe = T_aft . T_bef^-1 . T_sum (the mapping prior and fusion)."""
    r_sum = pose_rot_mat(transform_sum)
    r_bef = pose_rot_mat(transform_bef)
    r_aft = pose_rot_mat(transform_aft)
    r_tobe = mat3_mul(mat3_mul(r_aft, mat3_transpose(r_bef)), r_sum)
    rot = euler_yxz(r_tobe)
    incre = apply_rot(mat3_transpose(r_sum),
                      transform_bef[POS] - transform_sum[POS])
    pos = transform_aft[POS] - apply_rot(r_tobe, incre)
    return torch.cat([rot, pos])


# ---------------------------------------------------------------------------
# Sweep deskew transforms.
# ---------------------------------------------------------------------------

def transform_to_start(pts: Tensor, rel_frac: Tensor, transform: Tensor) -> Tensor:
    """Project points to sweep start under linear motion interpolation:
    p' = rotateZXY(p - s*t, -s*rz, -s*rx, -s*ry)."""
    s = rel_frac[..., None]
    p = pts - s * transform[POS]
    sr = -s * transform[ROT]
    m = rot_zxy_mat(sr[..., 2], sr[..., 0], sr[..., 1])
    return apply_rot_batched(m, p)


def transform_to_end(pts: Tensor, rel_frac: Tensor, transform: Tensor,
                     imu_start_rpy: Tensor, imu_end_rpy: Tensor,
                     imu_shift_from_start: Tensor) -> Tensor:
    """Project points to the sweep end frame, with the IMU start/end
    re-rotation."""
    p = transform_to_start(pts, rel_frac, transform)
    r = transform[ROT]
    p = apply_rot(rot_yxz_mat(r[1], r[0], r[2]), p)
    p = p + transform[POS] - imu_shift_from_start
    m_imu = rot_zxy_mat(imu_start_rpy[0], imu_start_rpy[1], imu_start_rpy[2])
    m_end = rot_yxz_mat(-imu_end_rpy[2], -imu_end_rpy[1], -imu_end_rpy[0])
    return apply_rot(m_end, apply_rot(m_imu, p))


def rad2deg(x: Tensor) -> Tensor:
    return x * (180.0 / math.pi)


def deg2rad(x: Tensor) -> Tensor:
    return x * (math.pi / 180.0)
