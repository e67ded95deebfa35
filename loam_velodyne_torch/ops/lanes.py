"""Lane forms: how a kernel wrapper runs under ``torch.func.vmap``.

The batched replay (``parallel/replay.py``) runs B independent
sequences as one op stream by vmapping the single-lane engine. A
kernel wrapper hands ``data_ptr()`` to its kernel, which a vmapped
(batched) tensor does not have, so each kernel is also a
``torch.library.custom_op`` whose vmap rule calls the kernel's lane
form on the real (B, ...) tensors: one launch for all B lanes. A kernel
has one launch path, its lane form: a single-lane call is the lane form
at B = 1, and goes through the op only when one of its arguments is
batched.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._C._functorch import is_batchedtensor

Tensor = torch.Tensor


def per_lane(fn: Callable, *args):
    """``fn`` applied lane by lane (each tensor argument indexed on its
    leading lane axis, the others passed as they are), its outputs
    stacked on a new leading axis: the plain twin of a lane form."""
    b = next(a for a in args if isinstance(a, Tensor)).shape[0]
    outs = [fn(*(a[i] if isinstance(a, Tensor) else a for a in args))
            for i in range(b)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def batched(*args) -> bool:
    """Whether any tensor argument is a vmapped (batched) tensor."""
    return any(isinstance(a, Tensor) and is_batchedtensor(a) for a in args)


class LaneOp:
    """A kernel's single-lane call, from its lane form ``lanes``. Called
    on unbatched tensors it is ``lanes`` at B = 1 (every tensor argument
    given a lane axis of 1, the outputs' taken off). Called under vmap
    it is the custom op ``loam::<name>``, whose rule moves every
    tensor's lane axis to the front (an unbatched tensor is expanded to
    all lanes), makes it contiguous and calls ``lanes`` once; its
    outputs carry the lane axis first. ``lanes`` is read at each call,
    so a caller may wrap it (to record the lane form's arguments, say)."""

    def __init__(self, name: str, schema: str, lanes: Callable):
        self.lanes = lanes
        self.op = torch.library.custom_op(f"loam::{name}", self.single,
                                          mutates_args=(), schema=schema)
        self.op.register_vmap(self._rule)

    def single(self, *args):
        out = self.lanes(*(a[None] if isinstance(a, Tensor) else a
                           for a in args))
        return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]

    def _rule(self, info, in_dims, *args):
        b = info.batch_size
        moved = []
        for a, d in zip(args, in_dims):
            if isinstance(a, Tensor):
                a = a.movedim(d, 0) if d is not None else a.expand(b, *a.shape)
                a = a.contiguous()
            moved.append(a)
        out = self.lanes(*moved)
        return out, ((0,) * len(out) if isinstance(out, tuple) else 0)

    def __call__(self, *args):
        return self.op(*args) if batched(*args) else self.single(*args)
