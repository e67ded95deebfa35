"""Feature extraction: curvature, rejection masks, corner/flat picks.

Counterpart of ``loam_velodyne_tpu/ops/features.py``, in its windowed
form (``_all_labels_pallas``): each (ring, region) row is labelled
inside a window of its ring (the region span plus the +-C suppression
spill) by kernel K2 (``ops/greedy_kernel.py``). The JAX package labels
full-width rings on the CPU instead; both forms give the same labels.

Top-k over candidates becomes a stable descending sort sliced to k:
``lax.top_k`` puts the lower index first among equal scores, and a
stable sort keeps that order, where ``torch.topk`` promises none.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from loam_velodyne_torch.config import Capacities, RegistrationConfig
from loam_velodyne_torch.ops.greedy_kernel import greedy_pick_rows
from loam_velodyne_torch.ops.voxel import voxel_downsample
from loam_velodyne_torch.types import PointSet, RingGrid

Tensor = torch.Tensor

LABEL_SHARP = 2
LABEL_LESS_SHARP = 1
LABEL_NEUTRAL = 0
LABEL_FLAT = -1


class SweepFeatures(NamedTuple):
    """The four feature clouds of one sweep, plus the () int32 count of
    points and voxel cells lost to fixed capacities."""

    sharp: PointSet
    less_sharp: PointSet
    flat: PointSet
    less_flat: PointSet
    dropped: Tensor = None


def top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k`` along the last axis: descending, ties to the lower
    index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sq_norm(d: Tensor) -> Tensor:
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def ring_curvature(xyz: Tensor, count: Tensor, c_region: int
                   ) -> Tuple[Tensor, Tensor]:
    """Windowed curvature per point of (R, P) ring rows:
    ||sum_{j in [-C, C]} p_{i+j} - (2C+1) p_i||^2, valid for
    i in [C, count-1-C] on rings with count-1 > 2C."""
    r, p_cap, _ = xyz.shape
    c = c_region
    pad = xyz.new_zeros((r, c, 3))
    xp = torch.cat([pad, xyz, pad], dim=1)
    cs = torch.cat([xyz.new_zeros((r, 1, 3)), torch.cumsum(xp, dim=1)], dim=1)
    window = cs[:, 2 * c + 1:] - cs[:, :-(2 * c + 1)]
    curv = _sq_norm(window - (2 * c + 1) * xyz)
    idx = torch.arange(p_cap, device=xyz.device)[None, :]
    e = (count - 1)[:, None]
    valid = (e > 2 * c) & (idx >= c) & (idx <= e - c)
    return curv, valid


def ring_rejection_mask(xyz: Tensor, count: Tensor, c_region: int) -> Tensor:
    """(R, P) bool mask of occluded-edge and parallel-beam points."""
    r, p_cap, _ = xyz.shape
    c = c_region
    dev = xyz.device
    idx = torch.arange(p_cap, device=dev)[None, :].expand(r, p_cap)
    e = (count - 1)[:, None]

    zero = xyz.new_zeros((r, 1, 3))
    nxt = torch.cat([xyz[:, 1:], zero], dim=1)
    prv = torch.cat([zero, xyz[:, :-1]], dim=1)
    d_next2 = _sq_norm(nxt - xyz)
    d_prev2 = _sq_norm(xyz - prv)
    dis2 = _sq_norm(xyz)
    depth = torch.sqrt(dis2)
    depth_n = torch.sqrt(_sq_norm(nxt))

    in_scan = (idx >= c) & (idx <= e - c - 1)
    big_gap = d_next2 > 0.1
    nearer_next = depth > depth_n
    safe_depth = depth.clamp(min=1e-12)
    safe_depth_n = depth_n.clamp(min=1e-12)
    wd_a = torch.sqrt(_sq_norm(nxt - xyz * (safe_depth_n / safe_depth)[..., None])
                      ) / safe_depth_n
    wd_b = torch.sqrt(_sq_norm(xyz - nxt * (safe_depth / safe_depth_n)[..., None])
                      ) / safe_depth
    occ_a = in_scan & big_gap & nearer_next & (wd_a < 0.1)      # [i-C, i]
    occ_b = in_scan & big_gap & ~nearer_next & (wd_b < 0.1)     # [i+1, i+C+1]
    parallel = (in_scan & ~occ_a
                & (d_next2 > 0.0002 * dis2) & (d_prev2 > 0.0002 * dis2))

    # Scatter-OR of index intervals through a difference array.
    dif = torch.zeros((r, p_cap + c + 2), dtype=torch.int32, device=dev)
    for mark, lo, hi in ((occ_a, (idx - c).clamp(min=0), idx + 1),
                         (occ_b, idx + 1, idx + c + 2),
                         (parallel, idx, idx + 1)):
        add = mark.to(torch.int32)
        dif = dif.scatter_add(1, lo, add).scatter_add(1, hi, -add)
    return torch.cumsum(dif, dim=1)[:, :p_cap] > 0


def suppression_extents(xyz: Tensor, count: Tensor, c_region: int
                        ) -> Tuple[Tensor, Tensor]:
    """Per-point left/right suppression run lengths (markAsPicked's walk
    stops at the first squared gap > 0.05)."""
    r, p_cap, _ = xyz.shape
    c = c_region
    dev = xyz.device
    idx = torch.arange(p_cap, device=dev)[None, :]
    nxt = torch.cat([xyz[:, 1:], xyz.new_zeros((r, 1, 3))], dim=1)
    step_ok = (_sq_norm(nxt - xyz) <= 0.05) & (idx + 1 <= (count - 1)[:, None])
    no = torch.zeros((r, c + 1), dtype=torch.bool, device=dev)

    right = torch.zeros((r, p_cap), dtype=torch.int32, device=dev)
    run = torch.ones((r, p_cap), dtype=torch.bool, device=dev)
    for k in range(c):
        shifted = torch.cat([step_ok[:, k:], no[:, :k]], dim=1)     # a[i+k]
        run = run & shifted
        right = right + run.to(torch.int32)

    left = torch.zeros((r, p_cap), dtype=torch.int32, device=dev)
    run = torch.ones((r, p_cap), dtype=torch.bool, device=dev)
    for k in range(1, c + 1):
        shifted = torch.cat([no[:, :k], step_ok[:, :-k]], dim=1)    # a[i-k]
        run = run & shifted
        left = left + run.to(torch.int32)
    return left, right


def region_bounds(count: Tensor, c_region: int, n_regions: int
                  ) -> Tuple[Tensor, Tensor]:
    """(R, J) integer region boundaries [sp, ep] within each ring row."""
    j = torch.arange(n_regions, device=count.device)[None, :]
    e = count.long()[:, None] - 1
    c = c_region
    sp = torch.div(c * (n_regions - j) + (e - c) * j, n_regions,
                   rounding_mode="floor")
    ep = torch.div(c * (n_regions - 1 - j) + (e - c) * (j + 1), n_regions,
                   rounding_mode="floor") - 1
    return sp, ep


class _Windows(NamedTuple):
    """Geometry of the (ring, region) windows of an (R, P) grid."""

    w: int
    off: Tensor        # (R*J,) window start column
    ring_row: Tensor   # (R*J,) ring of each row
    sp: Tensor         # (R, J)
    ep: Tensor
    region_ok: Tensor

    def take(self, a: Tensor) -> Tensor:
        """(R, P) -> (R*J, W): each row's window."""
        cols = self.off[:, None] + torch.arange(self.w, device=a.device)[None, :]
        return a[self.ring_row[:, None], cols]

    def place_sum(self, vals_w: Tensor, p: int) -> Tensor:
        """(R*J, W) -> (R, P): windows back at their offsets, summed over
        regions."""
        rows = vals_w.shape[0]
        cols = self.off[:, None] + torch.arange(self.w, device=vals_w.device)[None, :]
        out = vals_w.new_zeros((rows, p)).scatter(1, cols, vals_w)
        return out.reshape(-1, self.sp.shape[1], p).sum(1)


def _windows(count: Tensor, p: int, reg: RegistrationConfig) -> _Windows:
    j = reg.n_feature_regions
    c = reg.curvature_region
    r = count.shape[0]
    sp, ep = region_bounds(count, c, j)
    # Window width: the longest possible region plus the +-C spill.
    max_len = (p - 1 - 2 * c + j - 1) // j + 1
    w = min(((max_len + 2 * c + 127) // 128) * 128, p)
    off = (sp - c).clamp(0, p - w).reshape(-1)
    ring_row = torch.arange(r, device=count.device).repeat_interleave(j)
    return _Windows(w=w, off=off, ring_row=ring_row, sp=sp, ep=ep,
                    region_ok=ep > sp)


def _all_labels(grid: RingGrid, reg: RegistrationConfig) -> Tuple[Tensor, Tensor]:
    """Windowed (ring x region) greedy labeling through kernel K2.
    Returns ((R, P) int32 labels, (R, P) bool in-region)."""
    r, p = grid.xyz.shape[:2]
    c = reg.curvature_region
    win = _windows(grid.count, p, reg)

    curv, curv_valid = ring_curvature(grid.xyz, grid.count, c)
    rejected = ring_rejection_mask(grid.xyz, grid.count, c)
    left_ext, right_ext = suppression_extents(grid.xyz, grid.count, c)

    curv_w = win.take(curv).contiguous()
    left_w = win.take(left_ext).contiguous()
    right_w = win.take(right_ext).contiguous()
    picked0_w = win.take(rejected).contiguous()
    col_w = win.off[:, None] + torch.arange(win.w, device=curv.device)[None, :]
    sp_f, ep_f = win.sp.reshape(-1, 1), win.ep.reshape(-1, 1)
    in_region_w = ((col_w >= sp_f) & (col_w <= ep_f)
                   & win.region_ok.reshape(-1, 1) & win.take(curv_valid))

    def candidates(scores, cap):
        top, cand = top_k(scores, cap)
        return cand.to(torch.int32).contiguous(), torch.isfinite(top).contiguous()

    neg_inf = float("-inf")
    cand, ok = candidates(torch.where(in_region_w & ~picked0_w, curv_w, neg_inf),
                          reg.corner_scan_cap)
    corner_labels_w, corner_marks_w = greedy_pick_rows(
        curv_w, cand, ok, picked0_w, left_w, right_w,
        reg.surface_curvature_threshold, reg.max_corner_less_sharp,
        reg.max_corner_sharp, True)
    # Labels (region-disjoint, 0..2) in the low bits, mark spill above.
    packed = win.place_sum(corner_labels_w + 4 * corner_marks_w.to(torch.int32), p)
    labels = packed % 4
    picked1_w = win.take(rejected | (packed >= 4)).contiguous()

    cand, ok = candidates(torch.where(in_region_w & ~picked1_w, -curv_w, neg_inf),
                          reg.flat_scan_cap)
    flat_labels_w, _ = greedy_pick_rows(
        curv_w, cand, ok, picked1_w, left_w, right_w,
        reg.surface_curvature_threshold, reg.max_surface_flat, 0, False)
    labels = labels + win.place_sum(flat_labels_w, p)

    idx = torch.arange(p, device=curv.device)[None, None, :]
    any_region = ((idx >= win.sp[..., None]) & (idx <= win.ep[..., None])
                  & win.region_ok[..., None]).any(1) & curv_valid
    return labels, any_region


def _assemble_features(grid: RingGrid, labels: Tensor, in_region: Tensor,
                       reg: RegistrationConfig, caps: Capacities
                       ) -> SweepFeatures:
    """Feature clouds from the labeled grid: sharp / less-sharp / flat
    by a quota-sized top-k per region window (azimuth order) and a
    front-pack; less-flat by voxel-downsampling every in-region
    non-corner point."""
    r, p = labels.shape
    dev = labels.device
    win = _windows(grid.count, p, reg)
    rows = win.off.shape[0]
    labels_w = win.take(labels)
    valid_w = win.take(in_region & grid.mask)
    wincol = torch.arange(win.w, device=dev)[None, :]
    col_w = win.off[:, None] + wincol
    own = (valid_w & (col_w >= win.sp.reshape(-1, 1))
           & (col_w <= win.ep.reshape(-1, 1)) & win.region_ok.reshape(-1, 1))

    n = r * p
    flat_xyz = grid.xyz.reshape(n, 3)
    flat_rel = grid.rel.reshape(n)

    def cloud(match: Tensor, quota: int, capacity: int):
        # Ascending-column scores: each region's matches in azimuth order.
        top, kidx = top_k(torch.where(match, win.w - wincol, 0), quota)
        ok = top > 0
        gidx = win.ring_row[:, None] * p + win.off[:, None] + kidx
        gidx = torch.where(ok, gidx, 0).reshape(-1)
        okf = ok.reshape(-1)
        ring_col = win.ring_row.repeat_interleave(quota)
        # Front-pack, stable on the ring-major / azimuth row order.
        _, order = torch.sort((~okf).to(torch.int32), stable=True)
        src = gidx[order]
        xyz, rel, ring = flat_xyz[src], flat_rel[src], ring_col[order]
        n_rows = rows * quota
        if capacity > n_rows:
            xyz = torch.cat([xyz, xyz.new_zeros((capacity - n_rows, 3))])
            rel = torch.cat([rel, rel.new_zeros(capacity - n_rows)])
            ring = torch.cat([ring, ring.new_zeros(capacity - n_rows)])
        count = okf.sum(dtype=torch.int32)
        m = torch.arange(capacity, device=dev) < count.clamp(max=capacity)
        ps = PointSet(xyz=torch.where(m[:, None], xyz[:capacity], 0.0),
                      rel=torch.where(m, rel[:capacity], 0.0),
                      ring=torch.where(m, ring[:capacity], 0).to(torch.int32),
                      mask=m)
        return ps, (count - capacity).clamp(min=0)

    sharp, d_sharp = cloud(own & (labels_w == LABEL_SHARP),
                           reg.max_corner_sharp, caps.sharp)
    less_sharp, d_lsharp = cloud(own & (labels_w >= LABEL_LESS_SHARP),
                                 reg.max_corner_less_sharp, caps.less_sharp)
    flat, d_flat = cloud(own & (labels_w == LABEL_FLAT),
                         reg.max_surface_flat, caps.flat)

    # Less-flat candidates: in-region, valid, not a corner.
    cand = (in_region & grid.mask & (labels < LABEL_LESS_SHARP)).reshape(n)
    pool = PointSet(xyz=flat_xyz, rel=flat_rel,
                    ring=torch.arange(r, dtype=torch.int32,
                                      device=dev).repeat_interleave(p),
                    mask=cand)
    less_flat, voxel_dropped = voxel_downsample(
        pool, reg.less_flat_filter_size, caps.less_flat, per_ring=True,
        return_dropped=True)
    return SweepFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                         less_flat=less_flat,
                         dropped=d_sharp + d_lsharp + d_flat + voxel_dropped)


def extract_features(grid: RingGrid, reg: RegistrationConfig,
                     caps: Capacities) -> SweepFeatures:
    """Full-sweep feature extraction over the ring grid."""
    labels, in_region = _all_labels(grid, reg)
    return _assemble_features(grid, labels, in_region, reg, caps)
