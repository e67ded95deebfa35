"""Batched closed-form line and plane fits for the mapping stage.

Counterpart of ``loam_velodyne_tpu/ops/fit.py``: an analytic
trigonometric 3x3 symmetric eigensolver for the line fit and an
adjugate 3x3 solve for the plane fit. The small products are written
out as float32 multiply-adds (no batched library matmul, whose
precision would depend on the device's defaults).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from loam_velodyne_torch.utils.math import mat3_mul

Tensor = torch.Tensor

_EPS = 1e-12


def sym3x3_eigvalues(a: Tensor) -> Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    iso = p2 <= _EPS
    e_hi = torch.where(iso, q, e_hi)
    e_mid = torch.where(iso, q, e_mid)
    e_lo = torch.where(iso, q, e_lo)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def sym3x3_top_eigvector(a: Tensor, eigs: Tensor) -> Tensor:
    """Unit eigenvector of the largest eigenvalue: the largest column of
    (A - e_lo I)(A - e_mid I)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = mat3_mul(a - eigs[..., 0, None, None] * eye,
                 a - eigs[..., 1, None, None] * eye)
    norms = (m * m).sum(-2)                       # column squared norms
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(m, -1, best[..., None, None].expand(m.shape[:-1] + (1,)))[..., 0]
    n = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=_EPS))
    return v / n


def _gram(x: Tensor, y: Tensor) -> Tensor:
    """sum_k x[..., k, i] * y[..., k, j] -> (..., 3, 3)."""
    return (x[..., :, :, None] * y[..., :, None, :]).sum(-3)


def line_fit(neighbors: Tensor, eigen_ratio: float = 3.0
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fit an edge line to (..., K, 3) neighbor sets: (centroid,
    direction, valid) with valid = lambda_max > ratio * lambda_mid."""
    c = neighbors.mean(-2)
    d = neighbors - c[..., None, :]
    cov = _gram(d, d) / neighbors.shape[-2]
    eigs = sym3x3_eigvalues(cov)
    direction = sym3x3_top_eigvector(cov, eigs)
    valid = eigs[..., 2] > eigen_ratio * eigs[..., 1]
    return c, direction, valid


def solve3x3(a: Tensor, b: Tensor) -> Tensor:
    """Solve (...,3,3) @ x = (...,3) by the adjugate."""
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    det = torch.where(det.abs() < _EPS, _EPS, det)
    adj = torch.stack([
        torch.stack([c00,
                     m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2],
                     m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]], -1),
        torch.stack([c01,
                     m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0],
                     m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]], -1),
        torch.stack([c02,
                     m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1],
                     m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]], -1),
    ], -2)
    x = (adj * b[..., None, :]).sum(-1)
    return x / det[..., None]


def plane_fit(neighbors: Tensor, max_residual: float
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fit a plane n.x + d = 0 to (..., K, 3) neighbor sets through the
    A n = -1 normal equations: (unit normal, d, valid)."""
    ata = _gram(neighbors, neighbors)
    atb = -neighbors.sum(-2)
    n_raw = solve3x3(ata, atb)
    inv_norm = 1.0 / torch.sqrt(torch.clamp((n_raw * n_raw).sum(-1), min=_EPS))
    n = n_raw * inv_norm[..., None]
    d = inv_norm
    res = ((neighbors * n[..., None, :]).sum(-1) + d[..., None]).abs()
    valid = (res <= max_residual).all(-1)
    return n, d, valid
