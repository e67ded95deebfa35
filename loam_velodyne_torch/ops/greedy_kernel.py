"""K2: greedy suppressed feature pick over (ring, region) rows.

Replaces ``loam_velodyne_tpu/ops/pallas_greedy.py:greedy_pick_rows``
(``_greedy_kernel``). The pick is sequential by design: each pick
suppresses its neighbours before the next candidate is tested. On the
card the chain's latency bounds it, not bytes or arithmetic; the kernel
(``csrc/greedy.cu``) keeps each row's state in shared memory, one block
per row, so all rows advance in parallel and a step costs two block
barriers. The plain version below runs the same loop with one vector op
per step over all rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from loam_velodyne_torch.ops import cuda_lib

LABEL_SHARP = 2
LABEL_LESS_SHARP = 1
LABEL_FLAT = -1


def greedy_pick_rows_plain(curv, cand_idx, cand_ok, picked0, left_ext,
                           right_ext, threshold: float, quota: int,
                           sharp_quota: int, is_corner: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same loop, vectorized over rows)."""
    rows, w = curv.shape
    dev = curv.device
    col = torch.arange(w, device=dev)[None, :]
    picked = picked0.clone()
    labels = torch.zeros((rows, w), dtype=torch.int32, device=dev)
    n_picked = torch.zeros((rows,), dtype=torch.int32, device=dev)
    for k in range(cand_idx.shape[1]):
        idx = cand_idx[:, k:k + 1].long()                      # (rows, 1)
        c_i = curv.gather(1, idx)[:, 0]
        passes = c_i > threshold if is_corner else c_i < threshold
        eligible = (cand_ok[:, k] & ~picked.gather(1, idx)[:, 0] & passes
                    & (n_picked < quota))
        n_picked = n_picked + eligible.to(torch.int32)
        if is_corner:
            lab = torch.where(n_picked <= sharp_quota, LABEL_SHARP,
                              LABEL_LESS_SHARP).to(torch.int32)
        else:
            lab = torch.full((rows,), LABEL_FLAT, dtype=torch.int32, device=dev)
        old = labels.gather(1, idx)[:, 0]
        labels.scatter_(1, idx, torch.where(eligible, lab, old)[:, None])
        lo = idx - left_ext.gather(1, idx)
        hi = idx + right_ext.gather(1, idx)
        picked |= (col >= lo) & (col <= hi) & eligible[:, None]
    return labels, picked & ~picked0


def greedy_pick_rows(curv: torch.Tensor, cand_idx: torch.Tensor,
                     cand_ok: torch.Tensor, picked0: torch.Tensor,
                     left_ext: torch.Tensor, right_ext: torch.Tensor,
                     threshold: float, quota: int, sharp_quota: int,
                     is_corner: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """curv (rows, W) float32; cand_idx (rows, K) int32 in [0, W);
    cand_ok (rows, K) bool; picked0 (rows, W) bool; left/right (rows, W)
    int32. Runs the K candidate steps in order. Returns (labels (rows, W)
    int32, new marks (rows, W) bool)."""
    rows, w = curv.shape
    k_cap = cand_idx.shape[1]
    if (cand_ok.shape != cand_idx.shape or picked0.shape != curv.shape
            or left_ext.shape != curv.shape or right_ext.shape != curv.shape
            or cand_idx.shape[0] != rows):
        raise ValueError("greedy_pick_rows: shape mismatch")
    if (curv.dtype != torch.float32 or cand_idx.dtype != torch.int32
            or cand_ok.dtype != torch.bool or picked0.dtype != torch.bool
            or left_ext.dtype != torch.int32 or right_ext.dtype != torch.int32):
        raise TypeError("greedy_pick_rows: unexpected dtypes")
    if curv.device.type == "cpu":
        return greedy_pick_rows_plain(curv, cand_idx, cand_ok, picked0,
                                      left_ext, right_ext, threshold, quota,
                                      sharp_quota, is_corner)
    args = (curv, cand_idx, cand_ok, picked0, left_ext, right_ext)
    cuda_lib.check_cuda("greedy_pick_rows", *args)
    labels = torch.empty((rows, w), dtype=torch.int32, device=curv.device)
    marks = torch.empty((rows, w), dtype=torch.bool, device=curv.device)
    cuda_lib.launch("loam_greedy_pick_rows", curv.device,
                    *(a.data_ptr() for a in args), labels.data_ptr(),
                    marks.data_ptr(), rows, w, k_cap, float(threshold),
                    quota, sharp_quota, int(is_corner))
    greedy_pick_rows.launches += 1
    return labels, marks


greedy_pick_rows.launches = 0
