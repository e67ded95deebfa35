"""The compiled chunk and the compiled per-sweep step, as CUDA graphs.

``ChunkGraphs`` (below) replays the static chunk; ``SweepGraphs`` (at the
end) the per-sweep step's segments, the counterpart of the JAX driver's
jitted step (``loam_velodyne_tpu/io/driver.py:55-61``), whose GN is a
``lax.while_loop`` on the device: here each GN phase, and each iteration
after a phase's first, is captured under a conditional node that the
card skips once the GN has stopped (``models/conditional.py``), so no
stop flag is read on the host (``models/engine.py::step_graphed``
composes the segments).

The static chunk: one group of the static chunk as a CUDA graph.

Counterpart of ``jax.jit`` over the ``lax.scan`` of
``loam_velodyne_tpu/models/engine.py::run_chunk(static_cadence=True)``
(its scan body, ``engine.py:246-258``: one group of ``io_ratio``
sweeps, mapping off then on, the static GN schedules, whose
``lax.while_loop`` over phases leaves at the converged phase). The eager
chunk (``engine.run_chunk``) dispatches ~74k small operations a sweep
from Python and runs every phase masked; here one group of sweeps is
captured once as a CUDA graph and replayed, so the host launches one
graph a group, and the card skips the phases and iterations after a
GN's stop (on every lane, in the batched form).

A ``ChunkGraphs`` serves one caller (``Engine.run_chunk`` on the card,
``parallel/replay.py::make_batched_chunk``'s callable), the counterpart
of the JAX driver's dict of jitted chunk steps:

- **Keys.** A graph is captured on first use for each (device, shape of
  a group's sweeps, which includes B for the batched form, with or
  without IMU windows, the group's host branch). The branch is the
  host's decisions for each sweep of the group (``Cadence.initialized``
  and ``Cadence.gate``): they pick Python branches (odometry's first
  sweep) and Python constants (``mapping_inputs + int(mapping_input)``)
  that the graph bakes in, so the first group of a sequence and a
  steady group are two graphs. All graphs of a device share one memory
  pool (and the conditional bodies' pools).
- **Buffers.** The graphs own their inputs: the state, one group's raw
  sweeps and IMU windows, shared by the graphs of one shape. A call
  copies the caller's state in once, then for each group copies the
  group's sweeps in, replays, and clones the group's outputs; each
  replay ends by copying its new state into the state buffers (as the
  JAX driver donates its state). The call returns fresh tensors, so no
  caller holds memory that a later replay overwrites.
- **Capture.** A warm-up group runs eagerly on a side stream first (it
  builds the kernel library and initialises cuBLAS, cuSOLVER and the
  autograd engine's threads); then the group is captured on that
  stream, with the four kernels launched on it through
  ``ops/cuda_lib.py::launch``. A synchronising call raises inside the
  capture (``torch.cuda.set_sync_debug_mode("error")``), and Python's
  garbage collector is off during it (an earlier graph that an
  unreachable cycle held, destroyed mid-capture, invalidates the
  capture). A failed
  capture raises and names the last operation dispatched: there is no
  eager retry and no switch that turns the graph off. The warm-up's
  outputs are dropped; the state it reads is left as it was (the
  engine is a function of its state).
- **Launch counts.** A kernel wrapper captured into a graph counts its
  launch on the card, beside it (``ops/launches.py``): each replay adds
  the launches it runs, those inside a conditional node only when the
  card runs the node. ``launches.settle`` adds them to the wrappers'
  ``launches`` where the caller synchronises. The warm-up adds nothing,
  to them or to the tracing's counters.
- **Tracing** (``utils/profiling.py``, when on at the capture): the
  layers' stamps are nodes of the graph, and the copies around a replay
  (the caller's state and sweeps in, the outputs out: ``copy.in``,
  ``copy.out``) and a graph's own writes of its results (``copy.slots``)
  are stamped too.

The graphs run on a CUDA device only (``ChunkGraphs`` and
``SweepGraphs`` raise on any other); the CPU runs the eager chunk and
the eager step.
"""

from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import conditional
from loam_velodyne_torch.ops import (corresp_kernel, greedy_kernel,
                                     grid_kernel, knn_kernel, launches)
from loam_velodyne_torch.utils import profiling

Tensor = torch.Tensor

# The kernel wrappers whose launches the graphs count on the card.
COUNTED = (grid_kernel.grid_windows, greedy_kernel.greedy_pick_rows,
           corresp_kernel.corresp_search, knn_kernel.grouped_window_knn)

_pools: dict = {}


def pool(device: torch.device):
    """The memory pool that every graph on ``device`` shares."""
    if device not in _pools:
        _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def pool_bytes(device: torch.device) -> int:
    """Bytes of device memory the shared pool and the conditional
    bodies' pools hold."""
    want = {tuple(p) for p in [pool(device)] + conditional.pools(device)}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg.get("segment_pool_id", ())) in want)


def leaves(tree) -> list:
    """The tensors of a tree of (named) tuples, in order; other leaves
    (None, a Python int) skipped."""
    if isinstance(tree, tuple):
        return [t for x in tree for t in leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a tree of (named) tuples; other
    leaves kept as they are."""
    if isinstance(tree, tuple):
        items = [tree_map(fn, x) for x in tree]
        return tuple(items) if type(tree) is tuple else type(tree)(*items)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _cat(trees: list, dim: int):
    """Concatenate equal trees leaf by leaf along ``dim``."""
    first = trees[0]
    if isinstance(first, tuple):
        items = [_cat([t[i] for t in trees], dim) for i in range(len(first))]
        return tuple(items) if type(first) is tuple else type(first)(*items)
    return torch.cat(trees, dim)


def _graph_nodes(graph: int) -> Optional[int]:
    """Node count of a captured (not yet instantiated) graph, from the
    driver (``cuGraphGetNodes``)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = get_nodes(graph, None, ctypes.byref(count))
    return count.value if err == 0 else None


class _LastOp(TorchDispatchMode):
    """Remembers the last operation dispatched (to name a failure)."""

    last = "none"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


class GraphStats(NamedTuple):
    """One captured graph: the warm-up, capture and instantiation
    seconds (host clock, the card synchronised), its nodes (the
    conditional nodes' bodies included), its conditional nodes and the
    shared pools' bytes after it was captured."""

    warmup_s: float
    capture_s: float
    instantiate_s: float
    nodes: Optional[int]
    conditional_nodes: int
    pool_bytes: int


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    outs: object              # the group's outputs, in the graph's pool
    stats: GraphStats


class _Buffers(NamedTuple):
    state: object
    xyz: Tensor
    mask: Tensor
    wins: object


def _write_into(bufs: list, new: list) -> None:
    """Copy each new tensor into its buffer. One that shares memory with
    any of the buffers (and is not the very buffer it goes to) is cloned
    before any copy, so that no copy reads what another has
    overwritten."""
    held = {b.untyped_storage().data_ptr() for b in bufs}
    new = [n if n is b or n.untyped_storage().data_ptr() not in held
           else n.clone() for n, b in zip(new, bufs)]
    for b, n in zip(bufs, new):
        if n is not b:
            b.copy_(n)


def capture(device: torch.device, stream, warm: Callable, body: Callable,
            what: str) -> _Captured:
    """A CUDA graph of ``body()`` on ``stream``, after ``warm()`` ran
    eagerly on it (it builds the kernel library and initialises cuBLAS,
    cuSOLVER and the autograd engine's threads). The set-up synchronises
    the card; only the capture itself runs with synchronising calls as
    errors. No garbage is collected during the capture: a CUDA graph or
    event freed there (an unreachable cycle that held one) would
    invalidate it. A failed capture raises and names ``what`` and the
    last operation dispatched. The warm-up adds nothing to the wrappers'
    launch counts; the graph counts its launches on the card."""
    before = tuple(f.launches for f in COUNTED)
    caller_sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    gc_was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        conditional.prepare(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with launches.named_unchanged(), torch.cuda.stream(stream):
            warm()
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for f, n in zip(COUNTED, before):
            f.launches = n
        mode = _LastOp()
        try:
            with launches.on_card(device, COUNTED), \
                    torch.cuda.graph(graph, pool=pool(device), stream=stream):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with mode, conditional.recording() as regions:
                        outs = body()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of {what} failed; the last operation "
                f"dispatched was {mode.last}") from e
        t2 = time.perf_counter()
        top = _graph_nodes(graph.raw_cuda_graph())
        nodes = None if top is None else top + sum(regions)
        graph.instantiate()
        torch.cuda.synchronize(device)
        t3 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode(caller_sync_mode)
        if gc_was_enabled:
            gc.enable()
    stats = GraphStats(
        warmup_s=t1 - t0, capture_s=t2 - t1, instantiate_s=t3 - t2,
        nodes=nodes, conditional_nodes=len(regions),
        pool_bytes=pool_bytes(device))
    return _Captured(graph, outs, stats)


class ChunkGraphs:
    """The graphs of one group of the static chunk, by key.

    ``group(cadence)`` returns the eager function of one group,
    ``fn(state, xyz, mask, wins) -> (state, outputs)``, for the host
    cadence ``cadence`` at the group's start: ``io_ratio`` sweeps on
    axis ``sweep_axis`` of ``xyz`` / ``mask`` (and of each IMU window
    leaf), outputs stacked on that axis. Calling the object runs K
    sweeps (a multiple of ``io_ratio``, from a cadence on an
    ``io_ratio`` boundary) group by group through the graphs."""

    def __init__(self, cfg: LoamConfig, group: Callable, sweep_axis: int = 0):
        self.cfg = cfg
        self.group = group
        self.sweep_axis = sweep_axis
        self.io = cfg.odometry.io_ratio
        self._buffers: dict = {}
        self._graphs: dict = {}
        self._stream: dict = {}

    @property
    def stats(self) -> dict:
        """GraphStats of every graph captured so far, by key."""
        return {k: c.stats for k, c in self._graphs.items()}

    def branch(self, cadence) -> tuple:
        """The host's decisions for each sweep of the group starting at
        ``cadence``: (initialized, mapping_input, mapping_due)."""
        out = []
        for _ in range(self.io):
            out.append((cadence.initialized, *cadence.gate(self.cfg)))
            cadence = cadence.advance(self.cfg)
        return tuple(out)

    def groups(self, k: int, cadence) -> list:
        """The groups of K sweeps from ``cadence``: (index, the cadence at
        the group's start, its branch) for each."""
        io = self.io
        if k % io or cadence.sweep % io:
            raise ValueError(f"chunk (start {cadence.sweep}, length {k}) not "
                             f"aligned to io_ratio {io}")
        out = []
        for g in range(k // io):
            out.append((g, cadence, self.branch(cadence)))
            for _ in range(io):
                cadence = cadence.advance(self.cfg)
        return out

    def __call__(self, state, xyz: Tensor, mask: Tensor, wins, cadence):
        device = xyz.device
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}: "
                             "the CPU runs the eager chunk")
        ax, io = self.sweep_axis, self.io
        groups = self.groups(xyz.shape[ax], cadence)
        shape = tuple(xyz.shape[:ax]) + (io,) + tuple(xyz.shape[ax + 1:])
        bkey = (device, shape, wins is not None)
        bufs = self._buffers.get(bkey)
        if bufs is None:
            first = (lambda t: t.narrow(ax, 0, io).to(
                device, memory_format=torch.contiguous_format, copy=True))
            bufs = _Buffers(tree_map(lambda t: t.to(device, copy=True), state),
                            first(xyz), first(mask), tree_map(first, wins))
            self._buffers[bkey] = bufs
        with profiling.stamps("copy.in", xyz):
            self._copy_in(bufs.state, state)
        outs = []
        for g, start, branch in groups:
            part = (lambda t: t.narrow(ax, g * io, io))
            with profiling.stamps("copy.in", xyz):
                bufs.xyz.copy_(part(xyz))
                bufs.mask.copy_(part(mask))
                self._copy_in(bufs.wins, tree_map(part, wins))
            key = bkey + (branch,)
            cap = self._graphs.get(key)
            if cap is None:
                cap = self._graphs[key] = self._capture(bufs, start, device)
            cap.graph.replay()
            with profiling.stamps("copy.out", xyz):
                outs.append(tree_map(torch.clone, cap.outs))
        with profiling.stamps("copy.out", xyz):
            new_state = tree_map(torch.clone, bufs.state)
        return new_state, _cat(outs, ax)

    @staticmethod
    def _copy_in(bufs, tree) -> None:
        have, want = leaves(bufs), leaves(tree)
        if len(have) != len(want) or any(
                b.shape != t.shape or b.dtype != t.dtype
                for b, t in zip(have, want)):
            raise ValueError("the state or the IMU windows differ in layout "
                             "from the ones the graphs were captured with")
        for b, t in zip(have, want):
            b.copy_(t)

    def _capture(self, bufs: _Buffers, cadence, device) -> _Captured:
        fn = self.group(cadence)
        stream = self._stream.get(device)
        if stream is None:
            stream = self._stream[device] = torch.cuda.Stream(device)
        args = (bufs.state, bufs.xyz, bufs.mask, bufs.wins)

        def body():
            new_state, outs = fn(*args)
            self._end_state(bufs.state, new_state)
            return outs

        return capture(device, stream, lambda: fn(*args), body,
                       f"the static chunk (group shape {tuple(bufs.xyz.shape)}, "
                       f"branch {self.branch(cadence)})")

    @staticmethod
    def _end_state(state_bufs, new_state) -> None:
        """Copy the group's new state into the state buffers, inside the
        capture."""
        bufs = leaves(state_bufs)
        with profiling.stamps("copy.slots", bufs[0]):
            _write_into(bufs, leaves(new_state))


class Segment(NamedTuple):
    """One segment of the per-sweep step: ``fn(*reads)`` returns one tree
    per slot of ``writes``; ``reads`` and ``writes`` name slots of a
    ``SweepGraphs``."""

    fn: Callable
    reads: tuple
    writes: tuple


class SweepGraphs:
    """The per-sweep step's graphs on one card: one CUDA graph per
    segment key (``models/engine.py::step_graphed`` names the segments
    and their keys; ``parallel/replay.py::batched_step_graphed`` adds
    the batched step, one vmapped segment keyed by the sweep's shape
    and the IMU window's layout), all in the card's shared pool.

    - **Slots.** The segments pass their inputs and outputs through
      named slots: trees of device buffers outside the pool (the state,
      the raw sweep, the IMU window, the front's features, odometry's
      outputs, ...). A graph reads its slots and ends by copying its
      outputs into the slots it writes, so no data that outlives a
      replay sits in the pool, and the graphs may replay in any order
      and any number of times. ``load`` copies a caller's tree into a
      slot (the state, each call), ``take`` returns fresh copies of one.
    - **Capture.** A key's graph is captured at its first use, after a
      warm-up of its segment on a side stream that also allocates, from
      its outputs, the slots it is the first to write (so the slots hold
      valid values for the next segment's warm-up). A segment is a
      function of its slots: neither the warm-up nor the capture changes
      a slot.
    - **The GN's stop.** A GN's start, phases and end are one segment:
      each phase, and each iteration after a phase's first, is a
      conditional node that the card skips once the GN has stopped
      (``models/conditional.py``). Every graph replays unconditionally,
      and nothing is read back between replays.
    - **Launch counts** as in ``ChunkGraphs``: on the card.

    ``sweep_graphs`` gives every engine of one configuration on one card
    the same ``SweepGraphs``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.slots: dict = {}
        self._graphs: dict = {}
        self._stream = None
        self.replays = 0

    @property
    def stats(self) -> dict:
        """GraphStats of every graph captured so far, by key."""
        return {k: c.stats for k, c in self._graphs.items()}

    def load(self, slot, tree) -> None:
        """Copy a tree of tensors into the slot's buffers (made from the
        tree the first time)."""
        bufs = self.slots.get(slot)
        if bufs is None:
            self.slots[slot] = tree_map(
                lambda t: t.to(self.device, copy=True), tree)
        else:
            with profiling.stamps("copy.in", self.device):
                ChunkGraphs._copy_in(bufs, tree)

    def take(self, slot):
        """Fresh copies of a slot's tensors: no later replay writes them."""
        with profiling.stamps("copy.out", self.device):
            return tree_map(torch.clone, self.slots[slot])

    def run(self, key, segment: Segment) -> None:
        """Replay the graph of ``key``, captured on its first use."""
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(key, segment)
        cap.graph.replay()
        self.replays += 1

    def _capture(self, key, seg: Segment) -> _Captured:
        def args():
            return [self.slots[s] for s in seg.reads]

        def warm():
            for slot, tree in zip(seg.writes, seg.fn(*args())):
                if slot not in self.slots:
                    self.slots[slot] = tree_map(torch.clone, tree)

        return self._record(warm,
                            lambda: self._write(seg.writes, seg.fn(*args())),
                            f"the per-sweep segment {key}")

    def _record(self, warm: Callable, body: Callable, what: str) -> _Captured:
        """``capture`` on this card's side stream."""
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got "
                             f"{self.device}: the CPU runs the eager step")
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return capture(self.device, self._stream, warm, body, what)

    def _write(self, writes: tuple, outs: tuple) -> None:
        """Copy a segment's outputs into the slots it writes."""
        have, new = [], []
        for slot, tree in zip(writes, outs):
            bufs = leaves(self.slots[slot])
            got = leaves(tree)
            if len(bufs) != len(got) or any(
                    b.shape != t.shape or b.dtype != t.dtype
                    for b, t in zip(bufs, got)):
                raise ValueError(f"slot {slot!r}: a segment wrote another "
                                 "layout than the slot holds")
            have += bufs
            new += got
        with profiling.stamps("copy.slots", have[0]):
            _write_into(have, new)


_sweep_graphs: dict = {}


def sweep_graphs(cfg: LoamConfig, device) -> SweepGraphs:
    """The per-sweep graphs of ``cfg`` on ``device``, one for the
    process (as the JAX package keeps one compiled step per shape): the
    engines of one configuration share them, each graphed sweep copying
    its own state in (``SweepGraphs.load``)."""
    key = (cfg, torch.device(device))
    if key not in _sweep_graphs:
        _sweep_graphs[key] = SweepGraphs(device)
    return _sweep_graphs[key]
