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
"""

from __future__ import annotations

import torch

from loam_velodyne_torch.ops import cuda_lib


def grid_windows_plain(cols: torch.Tensor, starts: torch.Tensor,
                       p_cap: int) -> torch.Tensor:
    """Plain PyTorch version: one gather of R windows per column."""
    npad = cols.shape[1]
    s = starts.long().clamp(0, npad - p_cap)
    idx = s[:, None] + torch.arange(p_cap, device=cols.device)[None, :]
    return cols[:, idx].permute(1, 0, 2).contiguous()         # (R, C, P)


def grid_windows(cols: torch.Tensor, starts: torch.Tensor,
                 p_cap: int) -> torch.Tensor:
    """cols (C, Npad) float32, starts (R,) int32 -> (R, C, p_cap)."""
    if cols.dim() != 2 or starts.dim() != 1:
        raise ValueError("grid_windows: cols must be (C, Npad), starts (R,)")
    if cols.dtype != torch.float32 or starts.dtype != torch.int32:
        raise TypeError("grid_windows: cols float32, starts int32")
    if cols.shape[1] < p_cap:
        raise ValueError("grid_windows: Npad < p_cap")
    if cols.device.type == "cpu":
        return grid_windows_plain(cols, starts, p_cap)
    cuda_lib.check_cuda("grid_windows", cols, starts)
    c, npad = cols.shape
    r = starts.shape[0]
    out = torch.empty((r, c, p_cap), dtype=torch.float32, device=cols.device)
    cuda_lib.launch("loam_grid_windows", cols.device, cols.data_ptr(),
                    starts.data_ptr(), out.data_ptr(), r, c, npad, p_cap)
    grid_windows.launches += 1
    return out


grid_windows.launches = 0
