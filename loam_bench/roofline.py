"""The four kernels' share of their roofline on the calls a cell makes.

Each kernel's launch path is its module's ``lane_op.lanes`` (the lane
form, a single-lane call arriving with a lane axis of 1). ``recording``
wraps those four functions so that an eager replay of a few of the
cell's steps records every call's arguments; afterwards each recorded
call is given its least time on an H100 (``bound``, from the work its
own inputs need, against the published float32 and HBM3 peaks) and is
timed alone in a CUDA graph (``graph_ms``). The share is the sum of the
least times over the sum of the times.

``work`` and ``bound`` are frozen copies of the port's
``tools/kernel_times.py``; the K2 work counts the picks the call made
(its labels, recorded with its inputs).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

# Published H100 SXM peaks: float32 outside the tensor cores, HBM3.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_DISTANCE = 9    # 3 sub, 3 mul, 2 add, 1 compare against the best
LANE_SUFFIX = "_lanes"
CASES = {"grid_kernel": "grid", "greedy_kernel": "greedy",
         "corresp_kernel": "corresp", "knn_kernel": "knn"}


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def _lane(args: tuple, i: int) -> tuple:
    return tuple(a[i] if isinstance(a, torch.Tensor) else a for a in args)


def work(case: str, args: tuple, out: tuple = ()) -> Tuple[int, int]:
    """(operations, bytes) a call needs on these inputs (``out``: its
    outputs): each input byte read once, each output byte written once,
    and only the operations this data asks for. A lane form's work is the
    sum of its lanes'."""
    if case.endswith(LANE_SUFFIX):
        per = [work(case[:-len(LANE_SUFFIX)], _lane(args, i), _lane(out, i))
               for i in range(args[0].shape[0])]
        return sum(o for o, _ in per), sum(b for _, b in per)
    if case.startswith("grid"):
        cols, starts, p = args
        npad = cols.shape[1]
        s = np.clip(starts.cpu().numpy().astype(np.int64), 0, npad - p)
        covered = np.zeros(npad, bool)
        for a in s:
            covered[a:a + p] = True
        read = cols.shape[0] * int(covered.sum()) * 4 + _nbytes(starts)
        return 0, read + len(s) * cols.shape[0] * p * 4
    if case.startswith("greedy"):
        curv, cand, ok, picked0 = args[:4]
        rows, w = curv.shape
        ops = 4 * cand.numel()
        at_cand = torch.zeros((rows, w), dtype=torch.bool, device=curv.device)
        at_cand.scatter_(1, cand.long(), ok)
        n_picks = int((out[0] != 0).sum())
        read = (4 * int(at_cand.sum()) + 8 * n_picks
                + _nbytes(cand, ok, picked0))
        return ops, read + rows * w * 5
    if case.startswith("corresp"):
        q, ref, ring, mask, bracket, surf = args
        nq, m = q.shape[0], ref.shape[0]
        d2 = torch.zeros((nq, m), device=q.device)
        for k in range(3):
            d2 = d2 + (q[:, None, k] - ref[None, :, k]) ** 2
        j = torch.argmin(torch.where(mask[None, :], d2, float("inf")), dim=1)
        dring = ring[None, :] - ring[j][:, None]
        cand = (dring != 0) & (dring.abs() <= bracket)
        if surf:
            cand |= (dring == 0) & (torch.arange(m, device=q.device)[None, :]
                                    != j[:, None])
        n_valid = int(mask.sum())
        pass2 = int((cand & mask[None, :]).sum()) if n_valid else 0
        ops = OPS_PER_DISTANCE * (nq * n_valid + pass2)
        return ops, _nbytes(q, ref, ring, mask) + nq * 6 * 4
    if case.startswith("knn"):
        qg, win, k = args
        t, g, _ = qg.shape
        ops = OPS_PER_DISTANCE * t * g * win.shape[1]
        return ops, _nbytes(qg, win) + t * g * k * 8
    raise KeyError(case)


def bound_ms(case: str, args: tuple, out: tuple = ()) -> float:
    """The least time an H100 could take for the call: the larger of its
    operations over the float32 peak and its bytes over the memory
    rate."""
    ops, nbytes = work(case, args, out)
    return max(1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES)


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time a call of ``fn`` with the host out of the way:
    ``calls`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _modules():
    from loam_velodyne_torch.ops import (corresp_kernel, greedy_kernel,
                                         grid_kernel, knn_kernel)
    return {"grid_kernel": grid_kernel, "greedy_kernel": greedy_kernel,
            "corresp_kernel": corresp_kernel, "knn_kernel": knn_kernel}


@contextlib.contextmanager
def recording():
    """Inside the block every kernel call of the port is recorded: yields
    the list of (case, lane-form function, arguments copied, outputs)."""
    calls: List[tuple] = []
    mods = _modules()
    saved = {}
    for name, mod in mods.items():
        fn = mod.lane_op.lanes
        saved[name] = fn

        def rec(*args, _fn=fn, _case=CASES[name] + LANE_SUFFIX):
            copied = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args)
            out = _fn(*args)
            calls.append((_case, _fn, copied, tuple(out) if isinstance(
                out, (tuple, list)) else (out,)))
            return out

        mod.lane_op.lanes = rec
    try:
        yield calls
    finally:
        for name, mod in mods.items():
            mod.lane_op.lanes = saved[name]


def share(calls: List[tuple]) -> dict:
    """Σ least time and Σ graph time over the recorded calls (ms)."""
    out = {"bound_ms": 0.0, "time_ms": 0.0, "calls": len(calls)}
    for case, fn, args, res in calls:
        out["bound_ms"] += bound_ms(case, args, res)
        out["time_ms"] += graph_ms(lambda: fn(*args))
    return out
