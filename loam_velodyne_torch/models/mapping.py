"""Scan-to-map refinement over a rolling cube world map.

Counterpart of ``loam_velodyne_tpu/models/mapping.py``: toroidal cube
addressing, the two-tier slab + archive map, the windowed 5-NN through
kernel K4 and the batched closed-form fits, with both GN schedules of
``optimize_pose``: the static one (fits refreshed at each phase start,
iterations past the early abort frozen by masks, nothing read back;
each phase and each iteration after a phase's first a region of
``models/conditional.py``, which a CUDA graph skips on the card once
the GN has stopped) and the dynamic one (fits refreshed every
``corresp_refresh_every`` iterations, the loop left at the first
converged iteration, one read of the stop flag per iteration). ``step``
takes the IMU's sweep-end attitude for the 0.998 / 0.002 roll / pitch
blend. A step is three parts, which the per-sweep graphs compose:
``prepare`` (the stacks, the recentred window and the map clouds the GN
aligns to), the GN (``gn_targets``, then ``gn_phases``) and ``finish``
(the IMU blend, the map update and the telemetry). The exports
(``full_map``, ``surround_map``) and the archive's dedup compaction
(``compact_archive``) run off the per-sweep path.

Torch idiom where JAX needed its own:
- ``.at[idx].set(..., mode="drop")`` routes rejected rows to one spare
  row appended to the buffer, which is cut off afterwards (torch's
  ``index_put_`` raises on an out-of-range index instead of dropping);
- ``lax.dynamic_slice`` with a device start becomes a gather of
  ``start + arange(size)`` rows (start clamped, as XLA clamps it), so no
  value is read back to the host.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from loam_velodyne_torch.config import LoamConfig, MappingConfig
from loam_velodyne_torch.models import conditional
from loam_velodyne_torch.models.odometry import (GnCarry, degeneracy_projector,
                                                 gn_start, n_phases, solve_gn)
from loam_velodyne_torch.ops import fit
from loam_velodyne_torch.ops.features import top_k
from loam_velodyne_torch.ops.neighbors import (SortedCloud, sort_cloud,
                                               tiled_windowed_knn)
from loam_velodyne_torch.ops.voxel import voxel_downsample
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils import math as lm

Tensor = torch.Tensor

# 10 * sqrt(3) rounded as the JAX package rounds it (float32 product of
# float32 factors).
_FOV_TERM = float(np.float32(10.0) * np.float32(math.sqrt(3.0)))


class MappingState(NamedTuple):
    corner_xyz: Tensor       # (NC, CAP_C, 3) map corners, map frame
    corner_cnt: Tensor       # (NC,) int32
    surf_xyz: Tensor         # (NC, CAP_S, 3)
    surf_cnt: Tensor         # (NC,)
    origin: Tensor           # (3,) int32 world cube coord of the window start
    transform_tobe: Tensor   # (6,) pose being optimized
    transform_aft: Tensor    # (6,) last mapped pose
    transform_bef: Tensor    # (6,) odometry pose at the last mapping update
    map_frame: Tensor        # () int32 mapping-frame counter
    archive_xyz: Tensor      # (A, 3) spilled slab overflow
    archive_kind: Tensor     # (A,) int32 0=corner, 1=surf
    archive_valid: Tensor    # (A,) bool
    archive_cnt: Tensor      # () int32 append cursor
    archive_cursor: Tensor   # () int32 reinstatement cursor

    @staticmethod
    def create(cfg: LoamConfig, device) -> "MappingState":
        m = cfg.mapping
        nc, a = m.n_cubes, m.archive_capacity
        f32, i32 = torch.float32, torch.int32

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return MappingState(
            corner_xyz=z((nc, m.corner_cube_capacity, 3), f32),
            corner_cnt=z((nc,), i32),
            surf_xyz=z((nc, m.surf_cube_capacity, 3), f32),
            surf_cnt=z((nc,), i32),
            origin=torch.tensor([-m.center_width, -m.center_height,
                                 -m.center_depth], dtype=i32, device=device),
            transform_tobe=lm.identity_pose(device),
            transform_aft=lm.identity_pose(device),
            transform_bef=lm.identity_pose(device),
            map_frame=z((), i32),
            archive_xyz=z((a, 3), f32),
            archive_kind=z((a,), i32),
            archive_valid=z((a,), torch.bool),
            archive_cnt=z((), i32),
            archive_cursor=z((), i32))


class MapTelemetry(NamedTuple):
    """Per-frame overflow/shed counters, all () int32."""

    stack_corner_dropped: Tensor
    stack_surf_dropped: Tensor
    cube_corner_dropped: Tensor
    cube_surf_dropped: Tensor
    active_cube_deficit: Tensor
    archive_reinstated: Tensor

    @staticmethod
    def zero(device) -> "MapTelemetry":
        return MapTelemetry(*(torch.zeros((), dtype=torch.int32, device=device)
                              for _ in range(6)))


class MappingOutputs(NamedTuple):
    transform_aft: Tensor
    transform_bef: Tensor
    surround_due: Tensor     # () bool
    telemetry: MapTelemetry


# ---------------------------------------------------------------------------
# Small helpers.
# ---------------------------------------------------------------------------

def _dims(m: MappingConfig, device) -> Tensor:
    # Built by fills on the device: a small torch.tensor(list), or an
    # element set from a Python int (d[0] = w), is a copy from pageable
    # host memory, which waits for the stream and cannot be captured in
    # a CUDA graph.
    i = torch.arange(3, dtype=torch.int32, device=device)
    d = torch.full((3,), m.grid_depth, dtype=torch.int32, device=device)
    return d.masked_fill(i == 0, m.grid_width).masked_fill(i == 1, m.grid_height)


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def _rows(a: Tensor, start: Tensor, size: int) -> Tensor:
    """Row indices of ``lax.dynamic_slice_in_dim(a, start, size)``."""
    s = start.long().clamp(0, a.shape[0] - size)
    return s + torch.arange(size, device=a.device)


def _set_rows_drop(buf: Tensor, idx: Tensor, vals: Tensor) -> Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` for idx in [0, len]:
    entries equal to len land in a spare row that is cut off."""
    spare = buf.new_zeros((1,) + buf.shape[1:])
    out = torch.cat([buf, spare])
    out[idx.long()] = vals
    return out[:-1]


def _histogram(ids: Tensor, weights: Tensor, n_bins: int) -> Tensor:
    out = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
    return out.scatter_add(0, ids.long(), _i32(weights))


def _run_starts(key_sorted: Tensor) -> Tensor:
    """Whether each row starts a run of equal sorted keys."""
    return F.pad(key_sorted[1:] != key_sorted[:-1], (1, 0), value=True)


def _segment_rank(key_sorted: Tensor) -> Tensor:
    """Rank of each row within its run of equal sorted keys."""
    n = key_sorted.shape[0]
    i = torch.arange(n, dtype=torch.int32, device=key_sorted.device)
    seg_start = _run_starts(key_sorted)
    return i - torch.cummax(torch.where(seg_start, i, 0), 0).values


# ---------------------------------------------------------------------------
# Cube addressing.
# ---------------------------------------------------------------------------

def world_cube_coord(pos: Tensor, m: MappingConfig) -> Tensor:
    """World position -> integer cube coordinate, floor((p + 25) / 50)."""
    return _i32(torch.floor((pos + m.cube_size / 2) / m.cube_size))


def storage_index(w: Tensor, m: MappingConfig) -> Tensor:
    """(..., 3) world cube coords -> linear toroidal storage index."""
    s = torch.remainder(w, _dims(m, w.device))
    return (s[..., 0] + m.grid_width * s[..., 1]
            + m.grid_width * m.grid_height * s[..., 2])


def recenter(origin: Tensor, sensor_w: Tensor, m: MappingConfig
             ) -> Tuple[Tensor, Tensor]:
    """Advance the live window to keep the sensor >= margin cubes from
    every edge; returns (new_origin, clear_mask (NC,))."""
    d = _dims(m, origin.device)
    c = sensor_w - origin
    c_new = torch.minimum(torch.maximum(c, torch.full_like(c, m.recenter_margin)),
                          d - 1 - m.recenter_margin)
    new_origin = sensor_w - c_new

    def entering(axis, dim):
        coords = torch.arange(dim, dtype=torch.int32, device=origin.device)
        w = new_origin[axis] + torch.remainder(coords - new_origin[axis], dim)
        return (w < origin[axis]) | (w >= origin[axis] + dim)

    ei = entering(0, m.grid_width)
    ej = entering(1, m.grid_height)
    ek = entering(2, m.grid_depth)
    clear3 = ei[:, None, None] | ej[None, :, None] | ek[None, None, :]
    return new_origin, clear3.permute(2, 1, 0).reshape(-1)


def fov_valid_cubes(origin: Tensor, tobe: Tensor, m: MappingConfig
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """The (2r+1)^3 neighborhood around the sensor cube: storage
    indices, in-bounds + FOV validity, in-bounds validity."""
    dev = tobe.device
    pos = tobe[lm.POS]
    sensor_w = world_cube_coord(pos, m)
    r = m.neighborhood
    ax = torch.arange(-r, r + 1, dtype=torch.int32, device=dev)
    off = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    w = sensor_w[None, :] + off
    c = w - origin[None, :]
    in_bounds = ((c >= 0) & (c < _dims(m, dev)[None, :])).all(-1)

    centers = w.to(torch.float32) * m.cube_size
    # The sensor-frame point (0, 10, 0) in the map frame: R[:, 1] * 10 + t.
    y_axis_pt = lm.pose_rot_mat(tobe)[:, 1] * 10.0 + pos
    # The 8 cube-corner offsets (+-1 per axis) in meshgrid "ij" order.
    bits = torch.arange(8, device=dev)[:, None] >> torch.arange(2, -1, -1, device=dev)
    corner_off = ((bits & 1) * 2 - 1).to(torch.float32)
    corners = centers[:, None, :] + (m.cube_size / 2) * corner_off[None, :, :]

    def sq(a):
        d = a - corners
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]

    sq1 = sq(pos[None, None, :])
    sq2 = sq(y_axis_pt[None, None, :])
    term = _FOV_TERM * torch.sqrt(sq1)
    check1 = m.fov_half_aperture_term + sq1 - sq2 - term
    check2 = m.fov_half_aperture_term + sq1 - sq2 + term
    in_fov = ((check1 < 0) & (check2 > 0)).any(-1)
    return storage_index(w, m), in_bounds & in_fov, in_bounds


def assemble_map_cloud(cube_xyz: Tensor, cube_cnt: Tensor, sidx: Tensor,
                       valid: Tensor) -> Tuple[Tensor, Tensor]:
    """The slabs of the selected cubes as one padded cloud and its mask."""
    cap = cube_xyz.shape[1]
    sidx = sidx.long()
    cnt = torch.where(valid, cube_cnt[sidx], 0)
    mask = torch.arange(cap, device=cube_xyz.device)[None, :] < cnt[:, None]
    return cube_xyz[sidx].reshape(-1, 3), mask.reshape(-1)


# ---------------------------------------------------------------------------
# Map updates.
# ---------------------------------------------------------------------------

def scatter_into_cubes(cube_xyz: Tensor, cube_cnt: Tensor, pts: Tensor,
                       mask: Tensor, origin: Tensor, m: MappingConfig):
    """Append map-frame points into their cubes anywhere in the live
    window (fixed capacity, stable by input order). Returns (xyz, cnt,
    received (NC,), accepted (N,), in_window (N,)), the last two in
    input order."""
    nc, cap, _ = cube_xyz.shape
    n = pts.shape[0]
    dev = pts.device
    w = world_cube_coord(pts, m)
    c = w - origin[None, :]
    ok = mask & ((c >= 0) & (c < _dims(m, dev)[None, :])).all(-1)
    sidx = torch.where(ok, storage_index(w, m), nc)

    sidx_s, order = torch.sort(sidx, stable=True)
    pts_s = pts[order]
    ok_s = sidx_s < nc
    rank = _segment_rank(sidx_s)
    slot = cube_cnt[sidx_s.clamp(0, nc - 1).long()] + rank
    keep = ok_s & (slot < cap)
    flat = torch.where(keep, sidx_s * cap + slot, nc * cap)
    new_xyz = _set_rows_drop(cube_xyz.reshape(-1, 3), flat,
                             torch.where(keep[:, None], pts_s, 0.0)
                             ).reshape(nc, cap, 3)
    added = _histogram(sidx_s, keep, nc + 1)
    new_cnt = (cube_cnt + added[:nc]).clamp(max=cap)
    keep_in = torch.zeros(n, dtype=torch.bool, device=dev).scatter(0, order, keep)
    return new_xyz, _i32(new_cnt), added[:nc] > 0, keep_in, ok


def insert_into_local_slabs(local_xyz: Tensor, local_cnt: Tensor, pts: Tensor,
                            mask: Tensor, base_w: Tensor, m: MappingConfig):
    """Append map-frame points into the gathered neighborhood slabs
    (meshgrid order, corner cube ``base_w``). Returns (slabs, counts,
    received, (sorted_pts, overflow_mask), far_mask)."""
    l, cap, _ = local_xyz.shape
    n = pts.shape[0]
    side = 2 * m.neighborhood + 1
    rel3 = world_cube_coord(pts, m) - base_w[None, :]
    in_nbhd = ((rel3 >= 0) & (rel3 < side)).all(-1)
    far_mask = mask & ~in_nbhd
    ok = mask & in_nbhd
    lidx = torch.where(ok, rel3[:, 0] * side * side + rel3[:, 1] * side
                       + rel3[:, 2], l)

    lidx_s, order = torch.sort(lidx, stable=True)
    pts_s = pts[order]
    ok_s = ok[order]
    counts = _histogram(lidx, torch.ones_like(lidx), l + 1)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = (torch.arange(n, dtype=torch.int32, device=pts.device)
            - starts[lidx_s.clamp(0, l).long()])
    slot = local_cnt[lidx_s.clamp(0, l - 1).long()] + rank
    keep = ok_s & (slot < cap)
    flat = torch.where(keep, lidx_s * cap + slot, l * cap)
    new_xyz = _set_rows_drop(local_xyz.reshape(-1, 3), flat,
                             torch.where(keep[:, None], pts_s, 0.0)
                             ).reshape(l, cap, 3)
    added = _histogram(lidx_s, keep, l + 1)
    new_cnt = _i32(torch.clamp(local_cnt + added[:l], max=cap))
    return new_xyz, new_cnt, added[:l] > 0, (pts_s, ok_s & ~keep), far_mask


def _compact_xyz(xyz: Tensor, keep: Tensor, budget: int):
    """Front-pack kept rows of (N, 3) into ``budget`` rows (stable);
    returns (xyz, mask, dropped-over-budget)."""
    _, order = torch.sort(_i32(~keep), stable=True)
    x_s = xyz[order]
    if budget > xyz.shape[0]:
        x_s = torch.cat([x_s, x_s.new_zeros((budget - xyz.shape[0], 3))])
    n_keep = keep.sum(dtype=torch.int32)
    mask = torch.arange(budget, device=xyz.device) < n_keep.clamp(max=budget)
    return (torch.where(mask[:, None], x_s[:budget], 0.0), mask,
            (n_keep - budget).clamp(min=0))


def archive_append(pool, xyz: Tensor, mask: Tensor, kind: int, budget: int):
    """Compact masked rows to ``budget`` and append them at the pool
    cursor as one contiguous block blend; rows that do not fit are
    counted. Returns (pool, lost)."""
    pool_xyz, pool_kind, pool_valid, pool_cnt = pool
    add_xyz, add_mask, over_budget = _compact_xyz(xyz, mask, budget)
    dev = xyz.device
    a = pool_xyz.shape[0]
    n_add = add_mask.sum(dtype=torch.int32)
    n_fit = torch.minimum((a - pool_cnt).clamp(min=0), n_add)
    start = pool_cnt.clamp(max=a - budget)
    shift = pool_cnt - start
    j = torch.arange(budget, device=dev)
    writem = (j >= shift) & (j < shift + n_fit)
    rows = _rows(pool_xyz, start, budget)
    src = torch.remainder(j - shift, budget)          # jnp.roll by shift

    def blend(pool_arr, add_arr):
        wm = writem.reshape((budget,) + (1,) * (add_arr.dim() - 1))
        out = pool_arr.clone()
        out[rows] = torch.where(wm, add_arr[src], pool_arr[rows])
        return out

    pool_xyz = blend(pool_xyz, add_xyz)
    pool_kind = blend(pool_kind, torch.full((budget,), kind, dtype=torch.int32,
                                            device=dev))
    pool_valid = blend(pool_valid, torch.ones(budget, dtype=torch.bool,
                                              device=dev))
    lost = over_budget + (n_add - n_fit)
    return (pool_xyz, pool_kind, pool_valid, _i32(pool_cnt + n_fit)), _i32(lost)


def compact_archive(pool, m: MappingConfig):
    """Dedup and front-pack the archive pool: rows past the cursor and
    rows invalidated by recentering go, the first row of each (kind,
    voxel cell) stays, and survivors move to the front in (kind, cell)
    order, so the cursor equals the cell count. The JAX package's two
    packed int32 sort keys are one int64 key here."""
    xyz, kind, valid, cnt = pool
    a = xyz.shape[0]
    dev = xyz.device
    valid = valid & (torch.arange(a, device=dev) < cnt)
    leaf = torch.where(kind == 0, torch.full((), m.corner_leaf, device=dev),
                       torch.full((), m.surf_leaf, device=dev))
    cell = _i32(torch.floor(xyz / leaf[:, None])).clamp(-4096, 4095).long() + 4096
    # (invalid, kind, cx, cy, cz): 1 + 1 + 13 + 13 + 13 bits.
    key = (((~valid).long() << 40) + (kind.long() << 39) + (cell[:, 0] << 26)
           + (cell[:, 1] << 13) + cell[:, 2])
    key_s, order = torch.sort(key, stable=True)
    keep = valid[order] & _run_starts(key_s)
    _, order2 = torch.sort(_i32(~keep), stable=True)
    order = order[order2]
    n = keep.sum(dtype=torch.int32)
    return xyz[order], kind[order], torch.arange(a, device=dev) < n, n


def downsample_local_slabs(local_xyz: Tensor, local_cnt: Tensor, do: Tensor,
                           leaf: float) -> Tuple[Tensor, Tensor]:
    """Voxel-thin the selected slabs (one batched downsample)."""
    b, cap, _ = local_xyz.shape
    dev = local_xyz.device
    mask = (torch.arange(cap, device=dev)[None, :]
            < torch.where(do, local_cnt, 0)[:, None])
    zeros_f = torch.zeros((b, cap), dtype=torch.float32, device=dev)
    ps = PointSet(xyz=local_xyz, rel=zeros_f,
                  ring=torch.zeros((b, cap), dtype=torch.int32, device=dev),
                  mask=mask)
    out = voxel_downsample(ps, leaf, cap)
    ds_cnt = out.mask.sum(-1, dtype=torch.int32)
    return (torch.where(do[:, None, None], out.xyz, local_xyz),
            torch.where(do, ds_cnt, local_cnt))


def _select_active(flags: Tensor, k: int, weight: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Up to k set positions of a boolean vector, highest weight first
    (ties to the lower position); returns (positions (k,), active (k,))."""
    k = min(k, flags.shape[0])
    score = _i32(flags)
    if weight is not None:
        score = score * (1 + weight.clamp(max=2 ** 20))
    score, idx = top_k(score, k)
    return idx, score > 0


# ---------------------------------------------------------------------------
# Pose optimization.
# ---------------------------------------------------------------------------

def _map_point(tf: Tensor, pts: Tensor) -> Tensor:
    """pointAssociateToMap: X = R(theta) p + t."""
    return lm.pose_transform_points(tf, pts)


def _jacobian_rows(tf: Tensor, pts: Tensor, coeff: Tensor) -> Tensor:
    """d(coeff . (R(theta) p + t)) / d(theta, t), one row per point."""
    def scalar(tf_, p, c):
        return (c * _map_point(tf_, p)).sum()

    return vmap(grad(scalar), in_dims=(None, 0, 0))(tf, pts, coeff)


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt((x * x).sum(-1))


def _line_dist(x0: Tensor, a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Distance to the line through a, b and its gradient direction."""
    cvec = torch.linalg.cross(x0 - a, x0 - b, dim=-1)
    a012 = _norm(cvec)
    l12 = _norm(a - b)
    safe_a = a012.clamp(min=1e-12)
    safe_l = l12.clamp(min=1e-12)
    d = a012 / safe_l
    direction = torch.linalg.cross(a - b, cvec / safe_a[..., None],
                                   dim=-1) / safe_l[..., None]
    return d, direction


class GnTargets(NamedTuple):
    """What the map GN aligns: the frame's downsampled stacks and the
    map clouds sorted for the windowed 5-NN."""

    corner_stack: PointSet
    surf_stack: PointSet
    corner_sorted: SortedCloud
    surf_sorted: SortedCloud


def gn_targets(corner_stack: PointSet, surf_stack: PointSet,
               map_corner_xyz: Tensor, map_corner_mask: Tensor,
               map_surf_xyz: Tensor, map_surf_mask: Tensor,
               cfg: LoamConfig) -> Tuple[GnTargets, Tensor]:
    """The GN's targets, and whether it runs at all (the map clouds
    large enough)."""
    m = cfg.mapping
    run = ((map_corner_mask.sum() > m.min_corner_map_points)
           & (map_surf_mask.sum() > m.min_surface_map_points))
    return GnTargets(corner_stack, surf_stack,
                     sort_cloud(map_corner_xyz, map_corner_mask, axis=2),
                     sort_cloud(map_surf_xyz, map_surf_mask, axis=2)), run


def _refresh_fits(tf: Tensor, t: GnTargets, m: MappingConfig) -> tuple:
    """The 5-NN of each stack point at ``tf`` (K4) and the line / plane
    fits through them."""
    qc = _map_point(tf, t.corner_stack.xyz)
    _, d2_c, nbrs_c = tiled_windowed_knn(
        qc, t.corner_stack.mask, t.corner_sorted, k=5, window=m.knn_window,
        group=m.knn_group, return_neighbors=True)
    centroid, direction, line_ok = fit.line_fit(nbrs_c, m.line_eigen_ratio)
    pa = centroid + m.line_half_length * direction
    pb = centroid - m.line_half_length * direction
    qs = _map_point(tf, t.surf_stack.xyz)
    _, d2_s, nbrs_s = tiled_windowed_knn(
        qs, t.surf_stack.mask, t.surf_sorted, k=5, window=m.knn_window,
        group=m.knn_group, return_neighbors=True)
    normal, dplane, plane_ok = fit.plane_fit(nbrs_s, m.plane_max_residual)
    return (pa, pb,
            t.corner_stack.mask & (d2_c[:, 4] < m.nn_sq_dist_gate) & line_ok,
            normal, dplane,
            t.surf_stack.mask & (d2_s[:, 4] < m.nn_sq_dist_gate) & plane_ok)


def _iteration(tf, mat_p0, degenerate0, t: GnTargets, fits: tuple,
               m: MappingConfig, compute_projector: bool):
    """One map GN update against cached fits; returns (tf_new, mat_p,
    degenerate, done)."""
    pa, pb, cvalid, normal, dplane, svalid = fits
    qc = _map_point(tf, t.corner_stack.xyz)
    d_c, dir_c = _line_dist(qc, pa, pb)
    s_c = 1.0 - m.corner_weight_decay * d_c.abs()
    sel_c = cvalid & (s_c > m.weight_floor)
    coeff_c = (s_c[:, None] * dir_c) * sel_c[:, None]

    qs = _map_point(tf, t.surf_stack.xyz)
    d_s = (normal * qs).sum(-1) + dplane
    dist_s = torch.sqrt(_norm(qs))
    s_s = 1.0 - m.corner_weight_decay * d_s.abs() / dist_s.clamp(min=1e-6)
    sel_s = svalid & (s_s > m.weight_floor)
    coeff_s = (s_s[:, None] * normal) * sel_s[:, None]

    a_rows = torch.cat([_jacobian_rows(tf, t.corner_stack.xyz, coeff_c),
                        _jacobian_rows(tf, t.surf_stack.xyz, coeff_s)], dim=0)
    b_vec = torch.cat([-s_c * d_c * sel_c, -s_s * d_s * sel_s])
    enough = (sel_c.sum() + sel_s.sum()) >= m.min_selected
    x, ata = solve_gn(a_rows, b_vec)
    if compute_projector:
        p, dg = degeneracy_projector(ata, m.degeneracy_eigen_threshold)
        mat_p = torch.where(enough, p, mat_p0)
        degenerate = enough & dg
    else:
        mat_p, degenerate = mat_p0, degenerate0
    x = torch.where(degenerate, mat_p @ x, x)
    tf_new = tf + x
    tf_new = torch.where(torch.isfinite(tf_new), tf_new, 0.0)
    tf_new = torch.where(enough, tf_new, tf)
    delta_r = _norm(lm.rad2deg(x[:3]))
    delta_t = _norm(x[3:] * 100.0)
    done = enough & (delta_r < m.delta_r_abort) & (delta_t < m.delta_t_abort)
    return tf_new, mat_p, degenerate, done


def gn_phase(carry: GnCarry, phase: int, targets: GnTargets,
             cfg: LoamConfig) -> GnCarry:
    """Phase ``phase`` of the map GN: the 5-NN and fits refreshed at the
    carried pose (K4), then the phase's iterations against them, each
    after the stop frozen by masks and each after the phase's first a
    conditional region (as ``odometry.gn_phase``). Only the carry
    leaves a phase."""
    m = cfg.mapping
    fits = _refresh_fits(carry.tf, targets, m)

    def iteration(c: GnCarry, it: int) -> GnCarry:
        tf_new, mat_p_new, degen_new, done_step = _iteration(
            c.tf, c.mat_p, c.degenerate, targets, fits, m,
            compute_projector=(it == 0))
        active = ~c.done
        return GnCarry(torch.where(active, tf_new, c.tf),
                       torch.where(active, mat_p_new, c.mat_p),
                       torch.where(active, degen_new, c.degenerate),
                       c.done | (active & done_step))

    for j in range(m.corresp_refresh_every):
        it = phase * m.corresp_refresh_every + j
        if it >= m.max_iterations:
            break
        body = functools.partial(iteration, it=it)
        carry = (body(carry) if j == 0
                 else conditional.run_if_running(carry.done, body, carry))
    return carry


def gn_phases(carry: GnCarry, targets: GnTargets, cfg: LoamConfig) -> GnCarry:
    """Every refresh phase of the map GN from ``carry`` (``gn_phase``),
    each a conditional region: the JAX package's ``lax.while_loop`` over
    phases."""
    m = cfg.mapping
    for phase in range(n_phases(m.max_iterations, m.corresp_refresh_every)):
        carry = conditional.run_if_running(
            carry.done, lambda c, p=phase: gn_phase(c, p, targets, cfg),
            carry)
    return carry


def optimize_pose(corner_stack: PointSet, surf_stack: PointSet,
                  map_corner_xyz: Tensor, map_corner_mask: Tensor,
                  map_surf_xyz: Tensor, map_surf_mask: Tensor,
                  tobe0: Tensor, cfg: LoamConfig,
                  static_schedule: bool = True,
                  due: Optional[Tensor] = None) -> Tensor:
    """The <=10-iteration map-alignment GN. Static schedule: the phases
    of ``gn_phase``, early abort as masked freezing. Dynamic schedule:
    refreshed when ``it % corresp_refresh_every == 0``, the loop left at
    the first converged iteration (or at once when the map is too
    small), each read on the host. ``due``: a 0-d bool; where it is
    False the GN stops before it starts (a lane that does not map this
    sweep, in the batched step, which runs the static schedule)."""
    m = cfg.mapping
    targets, run = gn_targets(corner_stack, surf_stack, map_corner_xyz,
                              map_corner_mask, map_surf_xyz, map_surf_mask,
                              cfg)
    if due is not None:
        run = run & due
    if static_schedule:
        return gn_phases(gn_start(tobe0, run), targets, cfg).tf
    if not bool(run):
        return tobe0
    tf = tobe0
    mat_p = torch.eye(6, dtype=torch.float32, device=tobe0.device)
    degenerate = torch.zeros((), dtype=torch.bool, device=tobe0.device)
    for it in range(m.max_iterations):
        if it % m.corresp_refresh_every == 0:
            fits = _refresh_fits(tf, targets, m)
        tf, mat_p, degenerate, done = _iteration(
            tf, mat_p, degenerate, targets, fits, m,
            compute_projector=(it == 0))
        if bool(done):
            break
    return tf


# ---------------------------------------------------------------------------
# One mapping frame.
# ---------------------------------------------------------------------------

def _clip_tails(xyz: Tensor, cnt: Tensor, cap: int, m: MappingConfig):
    """Clip headroom slabs back to ``cap`` rows. The top over-capacity
    slabs are first reordered so an evenly spaced subset of their cells
    stays below ``cap``; the rest becomes the archive tail. Returns
    (slabs, counts, tail_xyz, tail_mask, missed)."""
    dev = xyz.device
    w = xyz.shape[1]
    hrw = w - cap
    pos, act = _select_active(cnt > cap, m.archive_cubes_per_frame, weight=cnt)
    rows = torch.arange(w, dtype=torch.int32, device=dev)
    sx, sc = xyz[pos], cnt[pos]
    sc_f = sc.clamp(min=1).to(torch.float32)
    # A true division: `cap / tensor` would compute reciprocal(x) * cap.
    ratio = torch.full_like(sc_f, float(cap)) / sc_f
    b_here = torch.floor(rows.to(torch.float32)[None, :] * ratio[:, None])
    b_prev = torch.floor((rows - 1).to(torch.float32)[None, :] * ratio[:, None])
    live = rows[None, :] < sc[:, None]
    keep = live & (b_here != b_prev)
    key = torch.where(live, torch.where(keep, 0, 1), 2)
    _, order = torch.sort(key, dim=1, stable=True)
    sel = torch.gather(sx, 1, order[..., None].expand(-1, -1, 3))
    xyz = xyz.clone()
    xyz[pos] = torch.where(act[:, None, None], sel, sx)
    tail = xyz[pos][:, cap:, :]
    tcnt = torch.where(act, (sc - cap).clamp(0, hrw), 0)
    tmask = torch.arange(hrw, device=dev)[None, :] < tcnt[:, None]
    missed = (cnt - cap).clamp(min=0).sum() - tcnt.sum()
    return (xyz[:, :cap], cnt.clamp(max=cap), tail.reshape(-1, 3),
            tmask.reshape(-1), _i32(missed))


class MapFrame(NamedTuple):
    """A mapping frame before its GN (``prepare``): the pose to refine,
    the downsampled stacks, the recentred window and its FOV cubes, the
    local slabs, the active cubes and the map clouds they make."""

    odom_pose: Tensor
    tobe: Tensor
    corner_stack: PointSet
    surf_stack: PointSet
    stack_c_drop: Tensor
    stack_s_drop: Tensor
    sensor_w: Tensor
    new_origin: Tensor
    corner_cnt: Tensor
    surf_cnt: Tensor
    arch_valid: Tensor
    arch_wanted: Tensor
    sidx: Tensor
    valid_fov: Tensor
    in_bounds: Tensor
    local_c: Tensor
    local_cc: Tensor
    local_s: Tensor
    local_sc: Tensor
    populated: Tensor
    pos_a: Tensor
    act_a: Tensor
    map_c_xyz: Tensor
    map_c_mask: Tensor
    map_s_xyz: Tensor
    map_s_mask: Tensor


def prepare(state: MappingState, odom_pose: Tensor, corner_cloud: PointSet,
            surf_cloud: PointSet, cfg: LoamConfig) -> MapFrame:
    """The frame up to its GN: the pose associated to the map, the
    stacks, the window recentred on the sensor (archive rows whose cube
    left it invalidated), the FOV cubes and the map clouds of the active
    ones."""
    m = cfg.mapping
    dev = odom_pose.device

    tobe = lm.transform_associate_to_map(odom_pose, state.transform_bef,
                                         state.transform_aft)
    corner_stack, stack_c_drop = voxel_downsample(
        corner_cloud, m.corner_leaf, m.corner_stack_capacity, return_dropped=True)
    surf_stack, stack_s_drop = voxel_downsample(
        surf_cloud, m.surf_leaf, m.surf_stack_capacity, return_dropped=True)

    # Recenter; archive rows whose cube left the window are invalidated.
    dims = _dims(m, dev)
    sensor_w = world_cube_coord(tobe[lm.POS], m)
    new_origin, clear = recenter(state.origin, sensor_w, m)
    corner_cnt = torch.where(clear, 0, state.corner_cnt)
    surf_cnt = torch.where(clear, 0, state.surf_cnt)
    arch_c = world_cube_coord(state.archive_xyz, m) - new_origin[None, :]
    arch_valid = state.archive_valid & (
        (arch_c >= 0) & (arch_c < dims[None, :])).all(-1)
    arch_wanted = arch_valid & (
        (arch_c - (sensor_w - new_origin)[None, :]).abs() <= m.neighborhood).all(-1)

    sidx, valid_fov, in_bounds = fov_valid_cubes(new_origin, tobe, m)
    sidx_l = sidx.long()
    local_c = state.corner_xyz[sidx_l]
    local_cc = torch.where(in_bounds, corner_cnt[sidx_l], 0)
    local_s = state.surf_xyz[sidx_l]
    local_sc = torch.where(in_bounds, surf_cnt[sidx_l], 0)

    populated = (local_cc + local_sc) > 0
    pos_a, act_a = _select_active(valid_fov, m.max_active_cubes,
                                  weight=local_cc + local_sc)

    map_c_xyz, map_c_mask = assemble_map_cloud(local_c, local_cc, pos_a, act_a)
    map_s_xyz, map_s_mask = assemble_map_cloud(local_s, local_sc, pos_a, act_a)
    return MapFrame(
        odom_pose=odom_pose, tobe=tobe, corner_stack=corner_stack,
        surf_stack=surf_stack, stack_c_drop=stack_c_drop,
        stack_s_drop=stack_s_drop, sensor_w=sensor_w, new_origin=new_origin,
        corner_cnt=corner_cnt, surf_cnt=surf_cnt, arch_valid=arch_valid,
        arch_wanted=arch_wanted, sidx=sidx, valid_fov=valid_fov,
        in_bounds=in_bounds, local_c=local_c, local_cc=local_cc,
        local_s=local_s, local_sc=local_sc, populated=populated, pos_a=pos_a,
        act_a=act_a, map_c_xyz=map_c_xyz, map_c_mask=map_c_mask,
        map_s_xyz=map_s_xyz, map_s_mask=map_s_mask)


def finish(state: MappingState, fr: MapFrame, tobe: Tensor,
           imu_rpy: Optional[Tuple[Tensor, Tensor]], cfg: LoamConfig
           ) -> Tuple[MappingState, MappingOutputs]:
    """The frame after its GN (``tobe``, the refined pose): the IMU's
    roll / pitch blend, the stacks inserted into the local slabs,
    re-thinned and clipped, the overflow archived, the slabs written
    back, far points and archive rows reinstated, and the telemetry."""
    m = cfg.mapping
    dev = tobe.device
    if imu_rpy is not None:
        rpy, imu_ok = imu_rpy
        blend = m.imu_blend
        rx = (1.0 - blend) * tobe[0] + blend * rpy[1]
        rz = (1.0 - blend) * tobe[2] + blend * rpy[0]
        tobe = torch.stack([torch.where(imu_ok, rx, tobe[0]), tobe[1],
                            torch.where(imu_ok, rz, tobe[2]), tobe[3],
                            tobe[4], tobe[5]])

    # Insert into headroom-padded local slabs, re-thin, clip back.
    base_w = fr.sensor_w - m.neighborhood
    corner_map_pts = _map_point(tobe, fr.corner_stack.xyz)
    surf_map_pts = _map_point(tobe, fr.surf_stack.xyz)
    nl = fr.local_c.shape[0]
    in_bounds = fr.in_bounds

    def pad_slab(x):
        return torch.cat([x, x.new_zeros((nl, m.insert_headroom, 3))], dim=1)

    local_c, local_cc, recv_c, ovf_c, far_c = insert_into_local_slabs(
        pad_slab(fr.local_c), fr.local_cc, corner_map_pts,
        fr.corner_stack.mask, base_w, m)
    local_s, local_sc, recv_s, ovf_s, far_s = insert_into_local_slabs(
        pad_slab(fr.local_s), fr.local_sc, surf_map_pts, fr.surf_stack.mask,
        base_w, m)

    def thin(xyz, cnt, recv, leaf):
        pos, act = _select_active(recv & in_bounds, m.thin_active_cubes,
                                  weight=cnt)
        sub_xyz, sub_cnt = downsample_local_slabs(xyz[pos], cnt[pos], act, leaf)
        xyz, cnt = xyz.clone(), cnt.clone()
        xyz[pos] = sub_xyz
        cnt[pos] = sub_cnt
        return xyz, cnt

    local_c, local_cc = thin(local_c, local_cc, recv_c, m.corner_leaf)
    local_s, local_sc = thin(local_s, local_sc, recv_s, m.surf_leaf)
    local_c, local_cc, tail_c, tmask_c, miss_c = _clip_tails(
        local_c, local_cc, m.corner_cube_capacity, m)
    local_s, local_sc, tail_s, tmask_s, miss_s = _clip_tails(
        local_s, local_sc, m.surf_cube_capacity, m)

    pool = (state.archive_xyz, state.archive_kind, fr.arch_valid,
            state.archive_cnt)
    pool, lost_c = archive_append(
        pool, torch.cat([ovf_c[0], tail_c]), torch.cat([ovf_c[1], tmask_c]),
        0, m.archive_append_budget)
    pool, lost_s = archive_append(
        pool, torch.cat([ovf_s[0], tail_s]), torch.cat([ovf_s[1], tmask_s]),
        1, m.archive_append_budget)
    arch_xyz, arch_kind, arch_valid, arch_cnt = pool
    cube_c_drop = miss_c + lost_c
    cube_s_drop = miss_s + lost_s

    # Whole-slab write-back; out-of-window aliases are dropped.
    nc = m.n_cubes
    sidx_safe = torch.where(in_bounds, fr.sidx, nc)
    corner_xyz = _set_rows_drop(state.corner_xyz, sidx_safe, local_c)
    corner_cnt = _set_rows_drop(fr.corner_cnt, sidx_safe, _i32(local_cc))
    surf_xyz = _set_rows_drop(state.surf_xyz, sidx_safe, local_s)
    surf_cnt = _set_rows_drop(fr.surf_cnt, sidx_safe, _i32(local_sc))

    # Far points and archive reinstatement ride one global scatter.
    fb = m.far_insert_budget
    far_c_xyz, far_c_mask, far_c_over = _compact_xyz(corner_map_pts, far_c, fb)
    far_s_xyz, far_s_mask, far_s_over = _compact_xyz(surf_map_pts, far_s, fb)

    rb = m.archive_reinstate_budget
    a_cap = arch_xyz.shape[0]
    cursor = state.archive_cursor
    rot = torch.remainder(torch.arange(a_cap, dtype=torch.int32, device=dev)
                          - cursor, a_cap)
    first = torch.where(fr.arch_wanted, rot, a_cap).min()
    limit = arch_cnt.clamp(min=1)
    r_start = torch.where(first < a_cap, torch.remainder(cursor + first, a_cap),
                          torch.remainder(cursor, limit))
    r_start = r_start.clamp(max=a_cap - rb)
    new_cursor = torch.remainder(r_start + max(rb, 1), limit)
    cand_rows = _rows(arch_xyz, r_start, rb)
    cand_xyz = arch_xyz[cand_rows]
    cand_kind = arch_kind[cand_rows]
    cand_valid = arch_valid[cand_rows]

    corner_xyz, corner_cnt, _, keep_c, ok_c = scatter_into_cubes(
        corner_xyz, corner_cnt, torch.cat([far_c_xyz, cand_xyz]),
        torch.cat([far_c_mask, cand_valid & (cand_kind == 0)]), fr.new_origin, m)
    surf_xyz, surf_cnt, _, keep_s, ok_s = scatter_into_cubes(
        surf_xyz, surf_cnt, torch.cat([far_s_xyz, cand_xyz]),
        torch.cat([far_s_mask, cand_valid & (cand_kind == 1)]), fr.new_origin, m)
    far_c_drop = (ok_c[:fb] & ~keep_c[:fb]).sum(dtype=torch.int32)
    far_s_drop = (ok_s[:fb] & ~keep_s[:fb]).sum(dtype=torch.int32)
    cube_c_drop = cube_c_drop + far_c_over + far_c_drop
    cube_s_drop = cube_s_drop + far_s_over + far_s_drop
    accepted = keep_c[fb:] | keep_s[fb:]
    arch_valid = arch_valid.clone()
    arch_valid[cand_rows] = cand_valid & ~accepted

    new_state = MappingState(
        corner_xyz=corner_xyz, corner_cnt=corner_cnt,
        surf_xyz=surf_xyz, surf_cnt=surf_cnt,
        origin=fr.new_origin, transform_tobe=tobe,
        transform_aft=tobe, transform_bef=fr.odom_pose,
        map_frame=state.map_frame + 1,
        archive_xyz=arch_xyz, archive_kind=arch_kind,
        archive_valid=arch_valid, archive_cnt=arch_cnt,
        archive_cursor=_i32(new_cursor))
    deficit = ((fr.valid_fov & fr.populated).sum()
               - (fr.act_a & fr.populated[fr.pos_a]).sum()).clamp(min=0)
    telemetry = MapTelemetry(
        stack_corner_dropped=_i32(fr.stack_c_drop),
        stack_surf_dropped=_i32(fr.stack_s_drop),
        cube_corner_dropped=_i32(cube_c_drop),
        cube_surf_dropped=_i32(cube_s_drop),
        active_cube_deficit=_i32(deficit),
        archive_reinstated=accepted.sum(dtype=torch.int32))
    surround_due = (state.map_frame % m.map_frame_num) == 0
    return new_state, MappingOutputs(transform_aft=tobe,
                                     transform_bef=fr.odom_pose,
                                     surround_due=surround_due,
                                     telemetry=telemetry)


def step(state: MappingState, odom_pose: Tensor, corner_cloud: PointSet,
         surf_cloud: PointSet, cfg: LoamConfig,
         imu_rpy: Optional[Tuple[Tensor, Tensor]] = None,
         static_schedule: bool = True, due: Optional[Tensor] = None
         ) -> Tuple[MappingState, MappingOutputs]:
    """One mapping refinement. imu_rpy: optional ((roll, pitch, yaw) at
    the sweep end, window has data) for the roll / pitch blend.

    ``due``: the mapping gate as a 0-d bool on the device (the batched
    step, where each lane maps on its own gate): ``prepare`` and
    ``finish`` each run under ``conditional.run_if_any`` (skipped on the
    card in a sweep where no lane is due) and the GN, in the static
    schedule, stops before it starts where ``due`` is False. What
    comes back is the mapped frame of every lane; the caller keeps it
    only where ``due`` holds (``engine.close``), as ``lax.cond`` under
    vmap selects."""
    if due is not None:
        fr = conditional.run_if_any(due, functools.partial(
            prepare, state, odom_pose, corner_cloud, surf_cloud, cfg))
        tobe = optimize_pose(fr.corner_stack, fr.surf_stack, fr.map_c_xyz,
                             fr.map_c_mask, fr.map_s_xyz, fr.map_s_mask,
                             fr.tobe, cfg, due=due)
        return conditional.run_if_any(due, functools.partial(
            finish, state, fr, tobe, imu_rpy, cfg))
    fr = prepare(state, odom_pose, corner_cloud, surf_cloud, cfg)
    tobe = optimize_pose(fr.corner_stack, fr.surf_stack, fr.map_c_xyz,
                         fr.map_c_mask, fr.map_s_xyz, fr.map_s_mask, fr.tobe,
                         cfg, static_schedule=static_schedule)
    return finish(state, fr, tobe, imu_rpy, cfg)


# ---------------------------------------------------------------------------
# Exports.
# ---------------------------------------------------------------------------

def full_map(state: MappingState, cfg: LoamConfig) -> Tuple[Tensor, Tensor]:
    """Every stored map point (corner and surf slabs, then the archive
    pool) across the whole window, with its validity mask."""
    def flatten(xyz, cnt):
        cap = xyz.shape[1]
        mask = torch.arange(cap, device=xyz.device)[None, :] < cnt[:, None]
        return xyz.reshape(-1, 3), mask.reshape(-1)

    cx, cm = flatten(state.corner_xyz, state.corner_cnt)
    sx, sm = flatten(state.surf_xyz, state.surf_cnt)
    a_mask = state.archive_valid & (
        torch.arange(state.archive_xyz.shape[0], device=cx.device)
        < state.archive_cnt)
    return torch.cat([cx, sx, state.archive_xyz]), torch.cat([cm, sm, a_mask])


def surround_map(state: MappingState, cfg: LoamConfig,
                 capacity: int = 65536) -> PointSet:
    """Downsized surround map: the corner and surf slabs of every
    in-window neighborhood cube and the archive rows whose cube lies in
    the neighborhood, voxel-thinned at the corner leaf."""
    m = cfg.mapping
    sidx, _, in_bounds = fov_valid_cubes(state.origin, state.transform_tobe, m)
    c_xyz, c_mask = assemble_map_cloud(state.corner_xyz, state.corner_cnt,
                                       sidx, in_bounds)
    s_xyz, s_mask = assemble_map_cloud(state.surf_xyz, state.surf_cnt,
                                       sidx, in_bounds)
    sensor_w = world_cube_coord(state.transform_tobe[lm.POS], m)
    rel3 = (world_cube_coord(state.archive_xyz, m)
            - (sensor_w - m.neighborhood)[None, :])
    side = 2 * m.neighborhood + 1
    a = state.archive_xyz.shape[0]
    a_mask = (state.archive_valid
              & (torch.arange(a, device=rel3.device) < state.archive_cnt)
              & ((rel3 >= 0) & (rel3 < side)).all(-1))
    xyz = torch.cat([c_xyz, s_xyz, state.archive_xyz])
    mask = torch.cat([c_mask, s_mask, a_mask])
    n = xyz.shape[0]
    ps = PointSet(xyz=xyz, rel=xyz.new_zeros(n),
                  ring=torch.zeros(n, dtype=torch.int32, device=xyz.device),
                  mask=mask)
    return voxel_downsample(ps, m.corner_leaf, capacity)
