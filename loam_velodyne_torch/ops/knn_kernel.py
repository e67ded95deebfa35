"""K4: exact top-5 per query against its group's window (mapping 5-NN).

Replaces ``loam_velodyne_tpu/ops/pallas_knn.py:grouped_window_knn``
(``_knn_kernel``). Queries come in T groups of G, each group with its
own contiguous window of W rows of the axis-sorted map cloud; for every
query the 5 smallest squared distances (difference form, float32) come
back ascending with their window columns, ties to the lower column.
Distances must be finite (padding rows sit at the far sentinel).

At VLP-16 a call is 16 (corner) or 32 (surf) groups of 128 queries
against windows of 1,024 rows: arithmetic below one launch's latency on
an H100, so what costs time is each query's serial scan and top-5
inserts, and one block per group left most of the 132 SMs idle. The
kernel (``csrc/knn.cu``) gives each query 16 lanes of a warp, each
scanning every 16th column of the window (staged once per block in
shared memory) into a register top-5, then merges the 16 lists by warp
shuffles on (distance, column), which keeps the sequential scan's
result bit for bit; blocks of 8 queries give 512 blocks at 32 groups.
The kernel is built for k = 5, the only k the mapping fits use; the
wrapper refuses any other.

Lane form (``grouped_window_knn_lanes``, the one launch path; a
single-lane call is B = 1): groups are independent, so B lanes fold
into B * T groups of the same kernel, one launch (128 and 256 groups at
VLP-16 with B = 8).
"""

from __future__ import annotations

from typing import Tuple

import torch

from loam_velodyne_torch.ops import cuda_lib, lanes


def grouped_window_knn_plain(q_groups: torch.Tensor, windows: torch.Tensor,
                             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the (T, G, W) distance block and a stable
    ascending sort (lower column first among equal distances)."""
    d2 = torch.zeros(q_groups.shape[:2] + (windows.shape[1],),
                     dtype=torch.float32, device=q_groups.device)
    for c in range(3):
        diff = q_groups[:, :, None, c] - windows[:, None, :, c]
        d2 = d2 + diff * diff
    vals, cols = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k].contiguous(), cols[..., :k].to(torch.int32).contiguous()


def grouped_window_knn_lanes_plain(q_groups: torch.Tensor,
                                   windows: torch.Tensor, k: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the lane form: the plain version lane by lane."""
    return lanes.per_lane(grouped_window_knn_plain, q_groups, windows, k)


def grouped_window_knn_lanes(q_groups: torch.Tensor, windows: torch.Tensor,
                             k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane form: q_groups (B, T, G, 3), windows (B, T, W, 3). Groups are
    independent, so the lanes fold into B * T groups of one launch."""
    if (q_groups.dim() != 4 or windows.dim() != 4
            or q_groups.shape[-1] != 3 or windows.shape[-1] != 3
            or q_groups.shape[:-2] != windows.shape[:-2]):
        raise ValueError("grouped_window_knn: expected (T, G, 3), (T, W, 3), "
                         "with one leading lane axis in the lane form")
    if q_groups.dtype != torch.float32 or windows.dtype != torch.float32:
        raise TypeError("grouped_window_knn: float32 inputs expected")
    if k != 5 or windows.shape[-2] < 5:
        raise ValueError("grouped_window_knn: k must be 5, with W >= 5")
    if q_groups.device.type == "cpu":
        return grouped_window_knn_lanes_plain(q_groups, windows, k)
    cuda_lib.check_cuda("grouped_window_knn", q_groups, windows)
    b, t, g, _ = q_groups.shape
    d2 = torch.empty((b, t, g, k), dtype=torch.float32, device=q_groups.device)
    cols = torch.empty((b, t, g, k), dtype=torch.int32, device=q_groups.device)
    cuda_lib.launch("loam_grouped_window_knn", q_groups.device,
                    q_groups.data_ptr(), windows.data_ptr(), d2.data_ptr(),
                    cols.data_ptr(), b * t, g, windows.shape[2])
    grouped_window_knn.launches += 1
    return d2, cols


lane_op = lanes.LaneOp(
    "grouped_window_knn",
    "(Tensor q_groups, Tensor windows, int k) -> (Tensor, Tensor)",
    grouped_window_knn_lanes)


def grouped_window_knn(q_groups: torch.Tensor, windows: torch.Tensor,
                       k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_groups (T, G, 3), windows (T, W, 3), float32 -> (sq_dists
    (T, G, k) ascending, window columns (T, G, k) int32): the lane form
    at B = 1, or under vmap over all lanes."""
    return lane_op(q_groups, windows, k)


grouped_window_knn.launches = 0
