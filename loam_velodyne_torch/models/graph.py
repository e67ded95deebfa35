"""The compiled chunk: one group of the static chunk as a CUDA graph.

Counterpart of ``jax.jit`` over the ``lax.scan`` of
``loam_velodyne_tpu/models/engine.py::run_chunk(static_cadence=True)``
(its scan body, ``engine.py:246-258``: one group of ``io_ratio``
sweeps, mapping off then on, the static GN schedules). The eager chunk
(``engine.run_chunk``) dispatches ~74k small operations a sweep from
Python; here one group of sweeps is captured once as a CUDA graph and
replayed, so the host launches one graph a group.

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
  pool.
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
- **Launch counts.** Each kernel wrapper counts its launches in Python,
  which runs only while a graph is captured. The capture records how
  many launches of each kernel one replay holds and adds them to the
  wrapper's ``launches`` on every replay; the warm-up and the capture
  add nothing. So a graphed run reads the counts of an eager one.

The graphs run on a CUDA device only (``ChunkGraphs`` raises on any
other); the CPU runs the eager chunk.
"""

from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.ops import (corresp_kernel, greedy_kernel,
                                     grid_kernel, knn_kernel)

Tensor = torch.Tensor

# The kernel wrappers whose launch counts the graphs keep.
COUNTED = (grid_kernel.grid_windows, greedy_kernel.greedy_pick_rows,
           corresp_kernel.corresp_search, knn_kernel.grouped_window_knn)

_pools: dict = {}


def pool(device: torch.device):
    """The memory pool that every graph on ``device`` shares."""
    if device not in _pools:
        _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def pool_bytes(device: torch.device) -> int:
    """Bytes of device memory the shared pool holds."""
    want = tuple(pool(device))
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg.get("segment_pool_id", ())) == want)


def leaves(tree) -> list:
    """The tensors of a tree of (named) tuples, in order; None skipped."""
    if isinstance(tree, tuple):
        return [t for x in tree for t in leaves(x)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a tree of (named) tuples."""
    if isinstance(tree, tuple):
        items = [tree_map(fn, x) for x in tree]
        return tuple(items) if type(tree) is tuple else type(tree)(*items)
    return None if tree is None else fn(tree)


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
    seconds (host clock, the card synchronised), its nodes, the shared
    pool's bytes after it was captured, and its launches of each
    counted kernel per replay."""

    warmup_s: float
    capture_s: float
    instantiate_s: float
    nodes: Optional[int]
    pool_bytes: int
    launches: dict


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    outs: object              # the group's outputs, in the graph's pool
    launches: tuple           # per replay, by COUNTED
    stats: GraphStats


class _Buffers(NamedTuple):
    state: object
    xyz: Tensor
    mask: Tensor
    wins: object


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
        self._copy_in(bufs.state, state)
        outs = []
        for g, start, branch in groups:
            part = (lambda t: t.narrow(ax, g * io, io))
            bufs.xyz.copy_(part(xyz))
            bufs.mask.copy_(part(mask))
            self._copy_in(bufs.wins, tree_map(part, wins))
            key = bkey + (branch,)
            cap = self._graphs.get(key)
            if cap is None:
                cap = self._graphs[key] = self._capture(bufs, start, device)
            cap.graph.replay()
            for fn, n in zip(COUNTED, cap.launches):
                fn.launches += n
            outs.append(tree_map(torch.clone, cap.outs))
        return tree_map(torch.clone, bufs.state), _cat(outs, ax)

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
        before = tuple(f.launches for f in COUNTED)
        stream = self._stream.get(device)
        if stream is None:
            stream = self._stream[device] = torch.cuda.Stream(device)
        args = (bufs.state, bufs.xyz, bufs.mask, bufs.wins)
        # The set-up synchronises the card; only the capture itself runs
        # with synchronising calls as errors. No garbage is collected
        # during the capture: a CUDA graph or event freed there (an
        # unreachable cycle that held one) would invalidate it.
        caller_sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        gc_was_enabled = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                fn(*args)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            mode = _LastOp()
            started = tuple(f.launches for f in COUNTED)
            try:
                with torch.cuda.graph(graph, pool=pool(device), stream=stream):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        with mode:
                            new_state, outs = fn(*args)
                            self._end_state(bufs.state, new_state)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
            except Exception as e:
                raise RuntimeError(
                    f"CUDA graph capture of the static chunk failed (group "
                    f"shape {tuple(bufs.xyz.shape)}, branch "
                    f"{self.branch(cadence)}); the last operation "
                    f"dispatched was {mode.last}") from e
            launches = tuple(f.launches - s for f, s in zip(COUNTED, started))
            for f, n in zip(COUNTED, before):
                f.launches = n
            t2 = time.perf_counter()
            nodes = _graph_nodes(graph.raw_cuda_graph())
            graph.instantiate()
            torch.cuda.synchronize(device)
            t3 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(caller_sync_mode)
            if gc_was_enabled:
                gc.enable()
        stats = GraphStats(
            warmup_s=t1 - t0, capture_s=t2 - t1, instantiate_s=t3 - t2,
            nodes=nodes, pool_bytes=pool_bytes(device),
            launches={f.__name__: n for f, n in zip(COUNTED, launches)})
        return _Captured(graph, outs, launches, stats)

    @staticmethod
    def _end_state(state_bufs, new_state) -> None:
        """Copy the group's new state into the state buffers, inside the
        capture (a leaf that shares memory with a buffer is cloned
        first, so no copy reads what another has overwritten)."""
        have, new = leaves(state_bufs), leaves(new_state)
        held = {b.untyped_storage().data_ptr() for b in have}
        new = [n if n is b or n.untyped_storage().data_ptr() not in held
               else n.clone() for n, b in zip(new, have)]
        for b, n in zip(have, new):
            if n is not b:
                b.copy_(n)
