"""Pose fusion: high-rate odometry x low-rate mapping correction.

Counterpart of ``loam_velodyne_tpu/models/fusion.py``: every odometry
pose is composed with the latest mapping correction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from loam_velodyne_torch.utils import math as lm


class FusionState(NamedTuple):
    transform_aft: torch.Tensor   # latest mapped pose
    transform_bef: torch.Tensor   # odometry pose the mapping used

    @staticmethod
    def create(device) -> "FusionState":
        return FusionState(transform_aft=lm.identity_pose(device),
                           transform_bef=lm.identity_pose(device))


def update_mapping(state: FusionState, transform_aft: torch.Tensor,
                   transform_bef: torch.Tensor) -> FusionState:
    """Cache a new mapping result."""
    return FusionState(transform_aft=transform_aft, transform_bef=transform_bef)


def fuse(state: FusionState, odom_pose: torch.Tensor) -> torch.Tensor:
    """Integrated pose for one odometry pose."""
    return lm.transform_associate_to_map(odom_pose, state.transform_bef,
                                         state.transform_aft)
