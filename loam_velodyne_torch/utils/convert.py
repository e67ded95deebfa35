"""Carry an engine state between the JAX package and the port.

LOAM has no weights: the carried state (map slabs, archive, poses,
counters) is what both implementations share. ``engine_state_from_numpy``
takes a JAX ``EngineState`` whose leaves are numpy arrays (as
``jax.device_get`` returns it) and builds the port's ``EngineState`` on
a device; ``engine_state_to_numpy`` goes back to numpy leaves. Fields
are matched by name, so this module needs neither JAX nor the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from loam_velodyne_torch.models.engine import EngineState
from loam_velodyne_torch.models.fusion import FusionState
from loam_velodyne_torch.models.mapping import MappingState
from loam_velodyne_torch.models.odometry import OdometryState
from loam_velodyne_torch.types import PointSet

# NamedTuple fields that are themselves NamedTuples.
_NESTED = {
    EngineState: {"odometry": OdometryState, "mapping": MappingState,
                  "fusion": FusionState},
    OdometryState: {"last_corner": PointSet, "last_surf": PointSet},
}


def state_from_numpy(cls, src, device):
    """A JAX NamedTuple with numpy leaves -> the port's NamedTuple ``cls``
    (fields matched by name, nested states converted recursively)."""
    nested = _NESTED.get(cls, {})
    leaves = []
    for name in cls._fields:
        value = getattr(src, name)
        if name in nested:
            leaves.append(state_from_numpy(nested[name], value, device))
        else:
            leaves.append(torch.from_numpy(np.array(value, copy=True)).to(device))
    return cls(*leaves)


def engine_state_from_numpy(tree, device) -> EngineState:
    """JAX EngineState with numpy leaves -> the port's EngineState."""
    return state_from_numpy(EngineState, tree, torch.device(device))


def to_numpy(tree):
    """A NamedTuple tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, tuple):
        return type(tree)(*(to_numpy(x) for x in tree))
    return tree.detach().cpu().numpy()


def engine_state_to_numpy(state: EngineState) -> EngineState:
    """The port's EngineState -> the same structure with numpy leaves."""
    return to_numpy(state)
