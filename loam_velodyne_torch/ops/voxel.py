"""Voxel-grid downsampling (PCL VoxelGrid equivalent), batched.

Counterpart of ``loam_velodyne_tpu/ops/voxel.py::voxel_downsample``:
quantize to cells relative to the valid-point minimum corner, sort so
cell-mates are adjacent, sum each cell's points, and keep one centroid
per cell in a fixed-capacity output; over capacity, evenly spaced cells
of the sort order are kept.

Differences in form, not in result:
- the two packed int32 sort keys become one int64 key (with the batch
  index on top, so a batch of clouds sorts in one call);
- the even-thin index ``ceil(k * S / C)`` is computed in int64;
- cell sums are ``torch.segment_reduce`` over the sorted rows: a
  sequential sum per cell in row order, deterministic on the card (an
  ``index_add_`` there would sum in atomic order); under vmap its lane
  form (``segment_sum_lanes``) runs the B lanes as one call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from loam_velodyne_torch.ops import lanes
from loam_velodyne_torch.types import PointSet


def segment_sum_lanes(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Lane form: (B, N, D) rows, (B, S) segment lengths, each lane's
    summing to N -> (B, S, D). The lanes' segments laid end to end make
    one ``segment_reduce`` call; each segment sums its own rows in their
    order, as in one lane."""
    b, s = lengths.shape
    out = torch.segment_reduce(data.reshape(-1, data.shape[-1]), "sum",
                               lengths=lengths.reshape(-1), unsafe=True)
    return out.reshape(b, s, -1)


def segment_sum_lanes_plain(data: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Plain twin of the lane form: one call per lane."""
    return lanes.per_lane(
        lambda d, n: torch.segment_reduce(d, "sum", lengths=n, unsafe=True),
        data, lengths)


lane_op = lanes.LaneOp(
    "segment_sum", "(Tensor data, Tensor lengths) -> Tensor", segment_sum_lanes)


def segment_sum(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of each run of ``lengths`` rows of ``data`` (N, D) -> (S, D):
    the lane form at B = 1 (``segment_reduce`` has no vmap rule, so
    under vmap the op's rule runs it over all lanes)."""
    return lane_op(data, lengths)


def voxel_downsample(ps: PointSet, leaf: float, capacity: int,
                     per_ring: bool = False, return_dropped: bool = False):
    """Centroid-per-voxel downsample of a padded point set.

    ``ps`` leaves may carry one leading batch axis ((B, N, 3) xyz); each
    batch row is downsampled on its own. per_ring=True puts the ring id
    into the cell identity. return_dropped=True also returns the number
    of occupied cells that did not fit ``capacity``.
    """
    batched = ps.xyz.dim() == 3
    if not batched:
        ps = PointSet(*(a[None] for a in ps))
    xyz, mask = ps.xyz, ps.mask
    dev = xyz.device
    b, n = mask.shape
    inv = 1.0 / leaf                  # applied as a float32 scalar

    mins = torch.where(mask[..., None], xyz, 1e9).amin(dim=1, keepdim=True)
    cell = torch.floor((xyz - mins) * inv).to(torch.int64)
    cell = torch.where(mask[..., None], cell, -1).clamp(-1, 4095)
    ring_key = (torch.where(mask, ps.ring, -1).long() if per_ring
                else torch.zeros_like(mask, dtype=torch.int64))

    # (batch, invalid, ring, cx, cy, cz) in one int64 key.
    key_hi = ((~mask).long() << 25) + ((ring_key + 1) << 13) + (cell[..., 0] + 1)
    key_lo = (cell[..., 1] + 1) * 4097 + (cell[..., 2] + 1)
    batch = torch.arange(b, device=dev, dtype=torch.int64)[:, None]
    key = (batch << 51) + (key_hi << 25) + key_lo
    key_s, order = torch.sort(key.reshape(-1), stable=True)   # rows of B*N
    xyz_s = xyz.reshape(-1, 3)[order]
    rel_s = ps.rel.reshape(-1)[order]
    ring_s = ps.ring.reshape(-1)[order]
    mask_s = mask.reshape(-1)[order]

    seg_start = F.pad(key_s[1:] != key_s[:-1], (1, 0), value=True) & mask_s
    # Segment ids from 1; id 0 takes leading padding rows. Padding rows
    # after a batch row's cells add zeros to its last cell.
    seg_id = torch.cumsum(seg_start, 0)
    n_seg = b * n + 1
    lengths = torch.zeros(n_seg, dtype=torch.int64, device=dev).scatter_add(
        0, seg_id, torch.ones_like(seg_id))
    payload = torch.cat([xyz_s, rel_s[:, None],
                         torch.ones_like(rel_s)[:, None]], dim=1)
    payload = torch.where(mask_s[:, None], payload, 0.0)
    sums = segment_sum(payload, lengths)
    ring_table = torch.full((n_seg,), 1 << 30, dtype=ring_s.dtype,
                            device=dev).scatter_reduce(
        0, seg_id, torch.where(mask_s, ring_s, 1 << 30), reduce="amin")

    n_cells = seg_start.reshape(b, n).sum(1)              # (B,)
    base = 1 + torch.cumsum(n_cells, 0) - n_cells         # first id per row
    k = torch.arange(capacity, dtype=torch.int64, device=dev)[None, :]
    stride_n = n_cells.clamp(min=capacity)[:, None]
    src = (k * stride_n + capacity - 1) // capacity       # ceil(k*S/C)
    src = src.clamp(max=n - 1)
    out_mask = k < n_cells.clamp(max=capacity)[:, None]
    gid = (base[:, None] + src).clamp(max=n_seg - 1)
    sums_k = sums[gid]                                    # (B, C, 5)
    denom = sums_k[..., 4].clamp(min=1.0)
    centroid = sums_k[..., :3] / denom[..., None]
    rel_mean = sums_k[..., 3] / denom
    out = PointSet(
        xyz=torch.where(out_mask[..., None], centroid, 0.0),
        rel=torch.where(out_mask, rel_mean, 0.0),
        ring=torch.where(out_mask, ring_table[gid], 0).to(torch.int32),
        mask=out_mask)
    dropped = (n_cells - capacity).clamp(min=0).to(torch.int32)
    if not batched:
        out = PointSet(*(a[0] for a in out))
        dropped = dropped[0]
    if return_dropped:
        return out, dropped
    return out
