"""Core point-data types as NamedTuples of torch tensors.

Counterpart of ``loam_velodyne_tpu/types.py``: the same field names,
shapes and dtypes (float32 coordinates, int32 ring ids, bool masks), so
a test can hand a structure from one package to the other leaf by leaf.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PointSet(NamedTuple):
    """A padded set of points.

    xyz:  (N, 3) float32 in LOAM's camera-style frame (x=left, y=up,
          z=forward).
    rel:  (N,)  float32 sweep-relative time fraction in [0, 1].
    ring: (N,)  int32 scan ring id.
    mask: (N,)  bool, True for real points.
    """

    xyz: torch.Tensor
    rel: torch.Tensor
    ring: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    @staticmethod
    def empty(capacity: int, device: torch.device) -> "PointSet":
        return PointSet(
            xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            rel=torch.zeros((capacity,), dtype=torch.float32, device=device),
            ring=torch.zeros((capacity,), dtype=torch.int32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class RingGrid(NamedTuple):
    """A sweep laid out as per-ring rows, azimuth-ordered within a row.

    xyz:   (R, P, 3) float32
    rel:   (R, P)    float32
    mask:  (R, P)    bool, front-packed
    count: (R,)      int32 valid points per ring
    dropped: ()      int32 valid raw points lost to the row capacity P
    """

    xyz: torch.Tensor
    rel: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    dropped: Optional[torch.Tensor] = None

    @property
    def n_rings(self) -> int:
        return self.xyz.shape[0]

    @property
    def row_capacity(self) -> int:
        return self.xyz.shape[1]
