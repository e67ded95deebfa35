"""Checkpoint and resume of an engine state.

Counterpart of ``loam_velodyne_tpu/utils/checkpoint.py``, in its file
format: one npz whose arrays ``leaf_0``, ``leaf_1``, ... are the state's
tensors in the order ``jax.tree_util.tree_flatten`` gives the JAX
package's ``EngineState`` (NamedTuple fields in order, depth first).
The port's own tree walk (``tree_leaves``) gives that order, since the
port's NamedTuples have the JAX package's fields in the JAX package's
order; so a checkpoint written by either package loads into the other.
Writes are atomic (a temporary file moved into place).
"""

from __future__ import annotations

import io
import os
from typing import Any, List

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of tuples, depth first, fields in order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[torch.Tensor]) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            return type(t)(*(build(sub) for sub in t))
        return next(it)

    return build(template)


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def save_pytree(path: str, tree: Any) -> None:
    """Write the tree's tensors as ``leaf_{i}`` arrays of one npz."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(tree_leaves(tree))}
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)   # a crash never leaves a torn checkpoint


def load_pytree(path: str, template: Any, device=None) -> Any:
    """Read a checkpoint into the structure, shapes and dtypes of
    ``template`` (whose tensors may be on the ``meta`` device), on
    ``device`` (default: each template tensor's device)."""
    leaves = tree_leaves(template)
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, template "
                             f"has {len(leaves)}: config mismatch?")
        new_leaves = []
        for i, tmpl in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                                 f"template shape {tuple(tmpl.shape)}: config "
                                 f"mismatch?")
            t = torch.from_numpy(arr.astype(_numpy_dtype(tmpl)))   # a copy
            new_leaves.append(t.to(tmpl.device if device is None else device))
    return tree_unflatten(template, new_leaves)
