"""K2: greedy suppressed feature pick over (ring, region) rows.

Replaces ``loam_velodyne_tpu/ops/pallas_greedy.py:greedy_pick_rows``
(``_greedy_kernel``). The pick is sequential by design: each pick
suppresses its neighbours before the next candidate is tested. On the
card a chain of K dependent steps per row bounds it, not bytes or
arithmetic. The kernel (``csrc/greedy.cu``) runs one warp per row and
does all that does not depend on earlier picks before the chain, in
parallel: each lane loads and tests its candidates and packs each one's
column, usability and clamped span into one 32-bit word. The row's
picked flags are bits, one 32-column word per lane, so a step is a
broadcast read of the candidate, one shuffle for the word that owns its
column, a bit test and an OR of the span; the steps run as a loop over
groups of 8, which keeps the code small, and stop with the group where
the quota fills or the row's last usable candidate falls
(``greedy_chain_steps`` counts them). That caps a row at ``MAX_W``
columns and ``MAX_K`` candidates; the wrapper refuses more. The plain
version below runs the same loop with one vector op per step over all
rows.

Lane form (``greedy_pick_rows_lanes``, the one launch path; a
single-lane call is B = 1): rows are independent, so B lanes fold into
B * rows rows of the same kernel, one launch (768 rows at VLP-16 with
B = 8).
"""

from __future__ import annotations

from typing import Tuple

import torch

from loam_velodyne_torch.ops import cuda_lib, lanes

LABEL_SHARP = 2
LABEL_LESS_SHARP = 1
LABEL_FLAT = -1

MAX_W = 1024       # one 32-bit word of picked flags per lane of a warp
MAX_K = 256        # eight candidate registers per lane


def greedy_pick_rows_plain(curv, cand_idx, cand_ok, picked0, left_ext,
                           right_ext, threshold: float, quota: int,
                           sharp_quota: int, is_corner: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same loop, vectorized over rows)."""
    labels, marks, _ = _pick_plain(curv, cand_idx, cand_ok, picked0, left_ext,
                                   right_ext, threshold, quota, sharp_quota,
                                   is_corner)
    return labels, marks


def greedy_chain_steps(curv, cand_idx, cand_ok, picked0, left_ext, right_ext,
                       threshold: float, quota: int, sharp_quota: int,
                       is_corner: bool) -> torch.Tensor:
    """(rows,) int32: the candidate steps each row's pick needs, up to
    its last candidate that could still be taken (usable, the quota not
    yet full); no later step can pick. The kernel's chain runs that
    rounded up to a group of 8, so its time follows the longest row."""
    return _pick_plain(curv, cand_idx, cand_ok, picked0, left_ext, right_ext,
                       threshold, quota, sharp_quota, is_corner)[2]


def _pick_plain(curv, cand_idx, cand_ok, picked0, left_ext, right_ext,
                threshold, quota, sharp_quota, is_corner):
    rows, w = curv.shape
    dev = curv.device
    col = torch.arange(w, device=dev)[None, :]
    picked = picked0.clone()
    labels = torch.zeros((rows, w), dtype=torch.int32, device=dev)
    n_picked = torch.zeros((rows,), dtype=torch.int32, device=dev)
    steps = torch.zeros((rows,), dtype=torch.int32, device=dev)
    for k in range(cand_idx.shape[1]):
        idx = cand_idx[:, k:k + 1].long()                      # (rows, 1)
        c_i = curv.gather(1, idx)[:, 0]
        passes = c_i > threshold if is_corner else c_i < threshold
        can = cand_ok[:, k] & passes & (n_picked < quota)
        eligible = can & ~picked.gather(1, idx)[:, 0]
        steps = torch.where(can, k + 1, steps)
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
    return labels, picked & ~picked0, steps


def greedy_pick_rows_lanes_plain(curv, cand_idx, cand_ok, picked0, left_ext,
                                 right_ext, threshold: float, quota: int,
                                 sharp_quota: int, is_corner: bool
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the lane form: the plain version lane by lane."""
    return lanes.per_lane(greedy_pick_rows_plain, curv, cand_idx, cand_ok,
                          picked0, left_ext, right_ext, threshold, quota,
                          sharp_quota, is_corner)


def greedy_pick_rows_lanes(curv, cand_idx, cand_ok, picked0, left_ext,
                           right_ext, threshold: float, quota: int,
                           sharp_quota: int, is_corner: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane form: every argument with a leading lane axis B ((B, rows, W)
    and (B, rows, K)). Rows are independent, so the lanes fold into rows:
    one launch over B * rows rows."""
    args = (curv, cand_idx, cand_ok, picked0, left_ext, right_ext)
    if curv.dim() != 3:
        raise ValueError("greedy_pick_rows: curv must be (rows, W), with one "
                         "leading lane axis in the lane form")
    if (cand_ok.shape != cand_idx.shape or picked0.shape != curv.shape
            or left_ext.shape != curv.shape or right_ext.shape != curv.shape
            or cand_idx.shape[:-1] != curv.shape[:-1]):
        raise ValueError("greedy_pick_rows: shape mismatch")
    if (curv.dtype != torch.float32 or cand_idx.dtype != torch.int32
            or cand_ok.dtype != torch.bool or picked0.dtype != torch.bool
            or left_ext.dtype != torch.int32 or right_ext.dtype != torch.int32):
        raise TypeError("greedy_pick_rows: unexpected dtypes")
    if curv.device.type == "cpu":
        return greedy_pick_rows_lanes_plain(*args, threshold, quota,
                                            sharp_quota, is_corner)
    b, rows, w = curv.shape
    k_cap = cand_idx.shape[-1]
    if w > MAX_W or k_cap > MAX_K:
        raise ValueError(f"greedy_pick_rows: the kernel takes W <= {MAX_W} "
                         f"and K <= {MAX_K}, got W={w}, K={k_cap}")
    cuda_lib.check_cuda("greedy_pick_rows", *args)
    labels = torch.empty((b, rows, w), dtype=torch.int32, device=curv.device)
    marks = torch.empty((b, rows, w), dtype=torch.bool, device=curv.device)
    cuda_lib.launch("loam_greedy_pick_rows", curv.device,
                    *(a.data_ptr() for a in args), labels.data_ptr(),
                    marks.data_ptr(), b * rows, w, k_cap, float(threshold),
                    quota, sharp_quota, int(is_corner))
    greedy_pick_rows.launches += 1
    return labels, marks


lane_op = lanes.LaneOp(
    "greedy_pick_rows",
    "(Tensor curv, Tensor cand_idx, Tensor cand_ok, Tensor picked0, "
    "Tensor left_ext, Tensor right_ext, float threshold, int quota, "
    "int sharp_quota, bool is_corner) -> (Tensor, Tensor)",
    greedy_pick_rows_lanes)


def greedy_pick_rows(curv: torch.Tensor, cand_idx: torch.Tensor,
                     cand_ok: torch.Tensor, picked0: torch.Tensor,
                     left_ext: torch.Tensor, right_ext: torch.Tensor,
                     threshold: float, quota: int, sharp_quota: int,
                     is_corner: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """curv (rows, W) float32; cand_idx (rows, K) int32 in [0, W);
    cand_ok (rows, K) bool; picked0 (rows, W) bool; left/right (rows, W)
    int32. Runs the K candidate steps in order. Returns (labels (rows, W)
    int32, new marks (rows, W) bool): the lane form at B = 1, or under
    vmap over all lanes."""
    return lane_op(curv, cand_idx, cand_ok, picked0, left_ext, right_ext,
                   float(threshold), quota, sharp_quota, is_corner)


greedy_pick_rows.launches = 0
