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
"""

from __future__ import annotations

from typing import Tuple

import torch

from loam_velodyne_torch.ops import cuda_lib


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


def grouped_window_knn(q_groups: torch.Tensor, windows: torch.Tensor,
                       k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_groups (T, G, 3), windows (T, W, 3), float32 -> (sq_dists
    (T, G, k) ascending, window columns (T, G, k) int32)."""
    if (q_groups.dim() != 3 or windows.dim() != 3 or q_groups.shape[2] != 3
            or windows.shape[2] != 3 or q_groups.shape[0] != windows.shape[0]):
        raise ValueError("grouped_window_knn: expected (T, G, 3), (T, W, 3)")
    if q_groups.dtype != torch.float32 or windows.dtype != torch.float32:
        raise TypeError("grouped_window_knn: float32 inputs expected")
    if k != 5 or windows.shape[1] < 5:
        raise ValueError("grouped_window_knn: k must be 5, with W >= 5")
    if q_groups.device.type == "cpu":
        return grouped_window_knn_plain(q_groups, windows, k)
    cuda_lib.check_cuda("grouped_window_knn", q_groups, windows)
    t, g, _ = q_groups.shape
    w = windows.shape[1]
    d2 = torch.empty((t, g, k), dtype=torch.float32, device=q_groups.device)
    cols = torch.empty((t, g, k), dtype=torch.int32, device=q_groups.device)
    cuda_lib.launch("loam_grouped_window_knn", q_groups.device,
                    q_groups.data_ptr(), windows.data_ptr(), d2.data_ptr(),
                    cols.data_ptr(), t, g, w)
    grouped_window_knn.launches += 1
    return d2, cols


grouped_window_knn.launches = 0
