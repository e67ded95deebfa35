"""Trajectory error (host-side, numpy): the absolute (ATE) and relative
(RPE) errors, as ``loam_velodyne_tpu/eval/metrics.py`` computes them."""

from __future__ import annotations

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Rigid (rotation+translation, no scale) alignment of est onto gt."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    cov = (gt - mu_g).T @ (est - mu_e) / len(est)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    t = mu_g - r @ mu_e
    return est @ r.T + t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = False) -> float:
    """Absolute trajectory error (RMSE over translation), meters."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align:
        est = umeyama_align(est, gt)
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def rpe_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             delta: int = 1) -> float:
    """Relative pose (translation-only) error over a frame delta, meters."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    err = de - dg
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
