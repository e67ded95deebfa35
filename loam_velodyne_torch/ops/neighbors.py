"""Correspondence search: masked brute-force and windowed neighbors.

Counterpart of ``loam_velodyne_tpu/ops/neighbors.py``. The odometry
pairs (point-to-line, point-to-plane) come from masked argmins over the
(Q, M) distance matrix, or from kernel K3 (``ops/corresp_kernel.py``)
in the ``*_fused`` forms the odometry uses; the mapping 5-NN runs
against an axis-sorted map cloud in per-group windows, through kernel
K4 (``ops/knn_kernel.py``). Distances are float32 in the difference
form throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from loam_velodyne_torch.ops.corresp_kernel import (corresp_search,
                                                    pairwise_sq_dist)
from loam_velodyne_torch.ops.knn_kernel import grouped_window_knn
from loam_velodyne_torch.types import PointSet

Tensor = torch.Tensor

NN_GATE_SQ = 25.0
RING_BRACKET = 2.5
FAR_SENTINEL = 1e8

__all__ = ["pairwise_sq_dist", "CornerMatch", "SurfMatch",
           "corner_correspondences", "surf_correspondences",
           "corner_correspondences_fused", "surf_correspondences_fused",
           "SortedCloud", "sort_cloud", "tiled_windowed_knn"]


class CornerMatch(NamedTuple):
    j: Tensor      # (Q,) nearest corner in the last cloud
    l: Tensor      # (Q,) second line point (different ring)
    valid: Tensor  # (Q,) both points found within the gates


class SurfMatch(NamedTuple):
    j: Tensor      # (Q,) nearest surfel
    l: Tensor      # (Q,) second point, same ring
    m: Tensor      # (Q,) third point, different ring
    valid: Tensor


def _masked_argmin(d2: Tensor, mask: Tensor):
    d = torch.where(mask, d2, float("inf"))
    idx = torch.argmin(d, dim=1)
    return idx, d.gather(1, idx[:, None])[:, 0]


def corner_correspondences(query_xyz: Tensor, query_mask: Tensor,
                           last: PointSet,
                           ring_bracket: float = RING_BRACKET) -> CornerMatch:
    """Point-to-line pairs by brute force (reference walk semantics)."""
    d2 = pairwise_sq_dist(query_xyz, last.xyz)
    j, dj = _masked_argmin(d2, last.mask[None, :])
    ok_j = (dj < NN_GATE_SQ) & query_mask
    dring = last.ring[None, :] - last.ring[j][:, None]
    bracket = ((dring != 0) & (dring.abs() <= ring_bracket)
               & last.mask[None, :])
    l, dl = _masked_argmin(d2, bracket)
    return CornerMatch(j=j.to(torch.int32), l=l.to(torch.int32),
                       valid=ok_j & (dl < NN_GATE_SQ))


def surf_correspondences(query_xyz: Tensor, query_mask: Tensor,
                         last: PointSet,
                         ring_bracket: float = RING_BRACKET) -> SurfMatch:
    """Point-to-plane tripods by brute force."""
    d2 = pairwise_sq_dist(query_xyz, last.xyz)
    j, dj = _masked_argmin(d2, last.mask[None, :])
    ok_j = (dj < NN_GATE_SQ) & query_mask
    dring = last.ring[None, :] - last.ring[j][:, None]
    col = torch.arange(last.xyz.shape[0], device=d2.device)[None, :]
    same_ring = (dring == 0) & (col != j[:, None]) & last.mask[None, :]
    diff_ring = ((dring != 0) & (dring.abs() <= ring_bracket)
                 & last.mask[None, :])
    l, dl = _masked_argmin(d2, same_ring)
    m, dm = _masked_argmin(d2, diff_ring)
    valid = ok_j & (dl < NN_GATE_SQ) & (dm < NN_GATE_SQ)
    return SurfMatch(j=j.to(torch.int32), l=l.to(torch.int32),
                     m=m.to(torch.int32), valid=valid)


def corner_correspondences_fused(query_xyz: Tensor, query_mask: Tensor,
                                 last: PointSet,
                                 ring_bracket: float = RING_BRACKET
                                 ) -> CornerMatch:
    """``corner_correspondences`` through kernel K3."""
    j, dj, l, dl, _, _ = corresp_search(query_xyz, last.xyz, last.ring,
                                        last.mask, float(ring_bracket),
                                        surf_mode=False)
    valid = (dj < NN_GATE_SQ) & query_mask & (dl < NN_GATE_SQ)
    return CornerMatch(j=j, l=l, valid=valid)


def surf_correspondences_fused(query_xyz: Tensor, query_mask: Tensor,
                               last: PointSet,
                               ring_bracket: float = RING_BRACKET) -> SurfMatch:
    """``surf_correspondences`` through kernel K3."""
    j, dj, l, dl, m, dm = corresp_search(query_xyz, last.xyz, last.ring,
                                         last.mask, float(ring_bracket),
                                         surf_mode=True)
    valid = ((dj < NN_GATE_SQ) & query_mask & (dl < NN_GATE_SQ)
             & (dm < NN_GATE_SQ))
    return SurfMatch(j=j, l=l, m=m, valid=valid)


class SortedCloud(NamedTuple):
    """A cloud sorted along one axis for windowed search; padding rows
    sit at the far sentinel, after every real row."""

    xyz: Tensor    # (M, 3)
    mask: Tensor   # (M,)
    keys: Tensor   # (M,) = xyz[:, axis], +inf for padding
    axis: int


def sort_cloud(xyz: Tensor, mask: Tensor, axis: int = 2) -> SortedCloud:
    keys = torch.where(mask, xyz[:, axis], float("inf"))
    keys_s, order = torch.sort(keys, stable=True)
    mask_s = mask[order]
    xyz_s = torch.where(mask_s[:, None], xyz[order], FAR_SENTINEL)
    return SortedCloud(xyz=xyz_s, mask=mask_s, keys=keys_s, axis=axis)


def tiled_windowed_knn(query_xyz: Tensor, query_mask: Tensor,
                       ref: SortedCloud, k: int, window: int,
                       group: int = 128, return_neighbors: bool = False):
    """k-NN against an axis-sorted cloud: queries sorted along the same
    axis, in groups of ``group``, each group searching one contiguous
    window of ``window`` rows centred on its median key (kernel K4).

    Returns (indices into the sorted cloud (Q, k), sq_dists (Q, k)) in
    the original query order, and with return_neighbors=True also the
    neighbour coordinates (Q, k, 3). Masked queries get inf distances.
    """
    q = query_xyz.shape[0]
    m = ref.xyz.shape[0]
    if q % group != 0:
        raise ValueError(f"query count {q} not a multiple of group {group}")
    t = q // group
    dev = query_xyz.device

    qkeys = torch.where(query_mask, query_xyz[:, ref.axis], float("inf"))
    qkeys_s, qid = torch.sort(qkeys, stable=True)
    q_sorted = query_xyz[qid]
    qmask_sorted = query_mask[qid]

    med = qkeys_s.reshape(t, group)[:, group // 2]
    med = torch.where(torch.isfinite(med), med, 0.0)
    pos = torch.searchsorted(ref.keys, med)
    start = (pos - window // 2).clamp(0, max(m - window, 0))
    rows = start[:, None] + torch.arange(window, device=dev)[None, :]
    windows = ref.xyz[rows]                                  # (T, W, 3)

    d2k, colk = grouped_window_knn(q_sorted.reshape(t, group, 3).contiguous(),
                                   windows.contiguous(), k=k)
    top = torch.where(qmask_sorted[:, None], d2k.reshape(q, k), float("inf"))
    widx = colk.reshape(q, k).long()
    idx_sorted = start.repeat_interleave(group)[:, None] + widx

    # Back to the query order through the inverse permutation of qid.
    inv = torch.zeros_like(qid).scatter(0, qid, torch.arange(q, device=dev))
    idx_out = idx_sorted.to(torch.int32)[inv]
    d2_out = top[inv]
    if not return_neighbors:
        return idx_out, d2_out
    tt = torch.arange(t, device=dev).repeat_interleave(group)[:, None]
    nbr = windows[tt, widx]                                  # (Q, k, 3)
    return idx_out, d2_out, nbr[inv]
