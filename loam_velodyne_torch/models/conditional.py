"""The GN loops' early exit on the card: CUDA-graph conditional nodes.

Counterpart of the JAX package's ``lax.while_loop`` over the GN's
refresh phases (the static schedules: ``_run_gn_static``,
``loam_velodyne_tpu/models/odometry.py:319-377``, and the static
``optimize_pose``, ``models/mapping.py:700-721``) and over its
iterations (the dynamic ones: ``run_gauss_newton``, ``odometry.py:246``,
and ``optimize_pose``, ``mapping.py:749``). XLA runs those loops on the
device and leaves them at the converged phase or iteration; under
``vmap`` a loop runs until no lane's condition holds.

``run_if_running(done, body, carry)`` is that exit for one region of
the GN (a refresh phase, or an iteration after a phase's first):

- **Eagerly** (the CPU, the card's eager forms, a graph's warm-up) it
  is ``body(carry)``. The masks in the body already make a finished
  carry's region change nothing, so the eager forms stay the plain
  reference and run every region.
- **While a CUDA graph is captured** it captures the region under an
  IF node (``csrc/cond.cu``) whose predicate, computed on the card, is
  "still running" (``running``): ``~done`` for one lane; under
  ``torch.func.vmap`` any lane's, through a custom op whose vmap rule
  reduces over the lanes and returns an unbatched flag, as the vmapped
  while_loop runs while any lane runs. A replay skips the region on the
  card when nothing runs, and nothing is read back to the host. Under
  the masks a lane that has stopped is left as it was by the regions
  its neighbours still run.

What a captured region may hold. The outputs are allocated before the
node, as a clone of the carry (the else branch is the identity), and the
body's results are copied into them inside it: a tensor first allocated
inside a region that a replay skips holds nothing, so nothing that
outlives the region may be born inside it. The body is captured on a
stream of its own, one for each depth of nesting (an iteration's node
lies inside its phase's), whose allocations the caching allocator
routes to a pool of its own for that depth. Those pools, like the
graphs' shared pool, live as long as the process: every graph's bodies
share them, and no value that outlives a replay sits in them.

``run_if_any(flag, body)`` is the batched step's ``lax.cond`` under
vmap (mapping's ``prepare`` and ``finish`` on the mapping gate): a
region under an IF node on "any lane's ``flag``", skipped on the card
in a sweep where no lane's holds. It has no carry: its results are
copied into tensors allocated inside the node on the capturing stream
from the graph's pool (an allocation adds no node), and its caller
keeps them only on the lanes whose ``flag`` holds (``torch.where``),
so what a skipped node leaves in them is never read.

Counts. A kernel launch captured inside a region is counted on the card
when the region runs (``ops/launches.py::count``). ``launches.needed``,
around an eager run, tallies the launches whose regions' predicates all
hold (``launches.within``, here): the independent expectation of a
graphed run's counts. The tracing's counters (``launches.lanes``, in the
GN's refresh phases) count the same way: in a capture when the card
runs the region, eagerly weighted by the predicates of the regions
around them.

A graphed path that cannot capture a conditional node raises and names
what is missing; nothing falls back to host reads or to running every
region.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from loam_velodyne_torch.ops import cuda_lib, lanes, launches

Tensor = torch.Tensor

# Depths of nesting a capture may reach: a phase, an iteration in it.
MAX_DEPTH = 2

_regions: Optional[list] = None  # recording()'s list of body node counts
_depth = 0                       # the nodes being captured, nested
_bodies: dict = {}              # (device, depth) -> (stream, pool id)


def _any_running(done: Tensor) -> Tensor:
    return ~done


def _any_running_rule(info, in_dims, done):
    """Under vmap: whether any lane still runs, unbatched."""
    return (~done).any(), None


_any_running_op = torch.library.custom_op(
    "loam::any_running", _any_running, mutates_args=(),
    schema="(Tensor done) -> Tensor")
_any_running_op.register_vmap(_any_running_rule)


def running(done: Tensor) -> Tensor:
    """The predicate of a region: ``~done`` (a 0-d bool); under vmap
    whether any lane still runs, an unbatched 0-d bool."""
    return _any_running_op(done) if lanes.batched(done) else ~done


def capturing(t: Tensor) -> bool:
    """Whether a CUDA graph is being captured on ``t``'s device."""
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _outputs(carry, done: Tensor):
    """A copy of the carry (a NamedTuple of tensors) to receive a
    region's results; under vmap every field batched like ``done`` (a
    field no lane has changed yet, an unbatched identity say, is spread
    over the lanes bit for bit)."""
    if lanes.batched(done):
        falses = torch.zeros_like(done)
        return type(carry)(*(torch.where(falses, t, t) for t in carry))
    return type(carry)(*(t.clone() for t in carry))


def run_if_running(done: Tensor, body: Callable, carry):
    """``body(carry)``, skipped on the card once ``done`` holds (on every
    lane, under vmap) where a CUDA graph is captured; eagerly always
    run. ``carry``: a NamedTuple of tensors, which ``body`` returns anew."""
    if not capturing(done):
        if not launches.tallying():
            return body(carry)
        with launches.within(running(done)):
            return body(carry)
    outs = _outputs(carry, done)

    def region():
        new = body(carry)
        if len(new) != len(outs) or any(
                n.shape != o.shape or n.dtype != o.dtype
                for n, o in zip(new, outs)):
            raise ValueError("a conditional region returned another layout "
                             "than its carry")
        for o, n in zip(outs, new):
            o.copy_(n)

    node(running(done), region)
    return outs


def run_if_any(flag: Tensor, body: Callable):
    """``body()``, skipped on the card where a CUDA graph is captured and
    ``flag`` holds on no lane; eagerly always run. The counterpart of a
    ``lax.cond`` on ``flag`` under vmap, whose caller selects each lane's
    branch: ``body`` returns a tree of (named) tuples of tensors, and the
    caller reads them only where ``flag`` holds (``torch.where`` over the
    lanes). In a capture the results are copied, inside the node, into
    tensors that are allocated there on the capturing stream from the
    graph's pool (an allocation adds no node to the graph), so they
    outlive the region; a replay that skips the node leaves in them
    whatever that memory held."""
    if not capturing(flag):
        if not launches.tallying():
            return body()
        with launches.within(running(~flag)):
            return body()
    outer = (torch.cuda.stream(torch.cuda.current_stream(flag.device))
             if flag.device.type == "cuda" else contextlib.nullcontext())
    made = []

    def region():
        new = body()
        with outer:
            outs = pytree.tree_map(torch.empty_like, new)
        for o, n in zip(pytree.tree_leaves(outs), pytree.tree_leaves(new)):
            o.copy_(n)
        made.append(outs)

    node(running(~flag), region)
    return made[0]


def _card(device) -> torch.device:
    """``device`` with its index (the current card's for a bare "cuda")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def recording():
    """Inside a capture: yields the list of the node counts of the
    conditional bodies captured in the block (``models/graph.py::capture``
    reads them)."""
    global _regions
    outer, _regions = _regions, []
    try:
        yield _regions
    finally:
        _regions = outer


def prepare(device: torch.device) -> None:
    """Before a capture on ``device``: each depth's body stream and pool,
    its cuBLAS and solver state set up by an eager matrix product and
    solve on it."""
    device = _card(device)
    if not hasattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool"):
        raise RuntimeError(
            f"torch {torch.__version__} has no "
            "_cuda_beginAllocateCurrentStreamToPool: a conditional node's "
            "body cannot allocate from a graph pool, so the GN's early "
            "exit cannot be captured")
    for depth in range(MAX_DEPTH):
        if (device, depth) in _bodies:
            continue
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            a = torch.eye(6, device=device) * 2.0
            torch.linalg.solve_ex(a @ a, torch.ones(6, device=device))
        torch.cuda.synchronize(device)
        _bodies[(device, depth)] = (stream, torch.cuda.graph_pool_handle())


def pools(device: torch.device) -> list:
    """The pool ids of ``device``'s body streams."""
    device = _card(device)
    return [pool_id for (d, _), (_, pool_id) in _bodies.items() if d == device]


def node(pred: Tensor, region: Callable) -> None:
    """Capture ``region()`` under an IF node on the card's 0-d bool
    ``pred``, inside ``recording()``."""
    global _depth
    if _regions is None:
        raise RuntimeError("a conditional node is captured only inside "
                           "models/graph.py::capture, which counts its "
                           "nodes")
    if pred.dtype != torch.bool or pred.dim() != 0 or pred.device.type != "cuda":
        raise ValueError(f"a conditional node needs a 0-d bool on the card, "
                         f"got {pred.dtype} of shape {tuple(pred.shape)} on "
                         f"{pred.device}")
    device = pred.device
    if (device, _depth) not in _bodies:
        raise RuntimeError(f"conditional nodes nest {_depth + 1} deep on "
                           f"{device}; prepare() made streams for "
                           f"{MAX_DEPTH}")
    body, pool_id = _bodies[(device, _depth)]
    cuda_lib.if_begin(pred, body, torch.cuda.current_stream(device))
    _depth += 1
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index,
                                                            pool_id)
            try:
                region()
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool_id)
    except BaseException:
        _depth -= 1
        with contextlib.suppress(RuntimeError):
            cuda_lib.if_end(body)
        raise
    _depth -= 1
    _regions.append(cuda_lib.if_end(body))
