"""K1: ring-grid window gather (ingest).

Replaces ``loam_velodyne_tpu/ops/pallas_grid.py:grid_windows``
(``_grid_kernel``). Row r of the (R, C, P) output is
``cols[:, starts[r] : starts[r] + P]``: pure data movement, bit-exact.
Its bytes (512 KB out at VLP-16) take less than a launch on the card,
so memory latency and the launch set its time; the kernel
(``csrc/grid.cu``) has every thread issue its 4 coalesced loads before
any store, over (R, C, ceil(P / 1024)) blocks, so the copy waits on
memory once. A start is clamped to ``[0, Npad - P]``, as a dynamic
slice clamps it; the caller pads the columns so that no real start
needs the clamp.

Lane form (``grid_windows_lanes``, the one launch path; a single-lane
call is B = 1): B lanes of (C, Npad) columns and R starts in one
launch, (B, R, C, P) out; the kernel clamps each start within its own
lane before it adds the lane's offset.
"""

from __future__ import annotations

import torch

from loam_velodyne_torch.ops import cuda_lib, lanes


def grid_windows_plain(cols: torch.Tensor, starts: torch.Tensor,
                       p_cap: int) -> torch.Tensor:
    """Plain PyTorch version: one gather of R windows per column."""
    npad = cols.shape[1]
    s = starts.long().clamp(0, npad - p_cap)
    idx = s[:, None] + torch.arange(p_cap, device=cols.device)[None, :]
    return cols[:, idx].permute(1, 0, 2).contiguous()         # (R, C, P)


def grid_windows_lanes_plain(cols: torch.Tensor, starts: torch.Tensor,
                             p_cap: int) -> torch.Tensor:
    """Plain twin of the lane form: the plain version lane by lane."""
    return lanes.per_lane(grid_windows_plain, cols, starts, p_cap)


def grid_windows_lanes(cols: torch.Tensor, starts: torch.Tensor,
                       p_cap: int) -> torch.Tensor:
    """Lane form: cols (B, C, Npad) float32, starts (B, R) int32 ->
    (B, R, C, p_cap), one launch."""
    if cols.dim() != 3 or starts.dim() != 2 or cols.shape[0] != starts.shape[0]:
        raise ValueError("grid_windows: cols must be (C, Npad), starts (R,), "
                         "with one leading lane axis in the lane form")
    if cols.dtype != torch.float32 or starts.dtype != torch.int32:
        raise TypeError("grid_windows: cols float32, starts int32")
    if cols.shape[-1] < p_cap:
        raise ValueError("grid_windows: Npad < p_cap")
    if cols.device.type == "cpu":
        return grid_windows_lanes_plain(cols, starts, p_cap)
    cuda_lib.check_cuda("grid_windows", cols, starts)
    b, c, npad = cols.shape
    r = starts.shape[1]
    out = torch.empty((b, r, c, p_cap), dtype=torch.float32,
                      device=cols.device)
    cuda_lib.launch("loam_grid_windows", cols.device, cols.data_ptr(),
                    starts.data_ptr(), out.data_ptr(), b, r, c, npad, p_cap)
    grid_windows.launches += 1
    return out


lane_op = lanes.LaneOp(
    "grid_windows", "(Tensor cols, Tensor starts, int p_cap) -> Tensor",
    grid_windows_lanes)


def grid_windows(cols: torch.Tensor, starts: torch.Tensor,
                 p_cap: int) -> torch.Tensor:
    """cols (C, Npad) float32, starts (R,) int32 -> (R, C, p_cap): the
    lane form at B = 1, or under vmap over all lanes."""
    return lane_op(cols, starts, p_cap)


grid_windows.launches = 0
