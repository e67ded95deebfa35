"""The four kernels' main-path inputs, bounds and timers on one CUDA card.

Builds each kernel's inputs at the main-path shapes of a lidar preset
(VLP-16 by default) from a numpy seed, computes each call's bound on an
H100 from those inputs, and times a callable with CUDA events:
back-to-back calls (host time included), calls captured in a CUDA graph
(the device's time with the host out of the way), the host's enqueue
time, and the device operations a call puts on the card
(``torch.profiler``). The lane forms' inputs are B main-path draws
stacked on a lane axis (``lane_inputs``), and their bound is the sum of
their lanes'. ``chip_smoke.py`` uses it for its kernel phase. Importing
the module builds no kernel.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.ops import greedy_kernel

# Published H100 SXM peaks: float32 outside the tensor cores, HBM3.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_DISTANCE = 9    # 3 sub, 3 mul, 2 add, 1 compare against the best


def main_path_inputs(dev: torch.device, seed: int = 0,
                     cfg: LoamConfig | None = None,
                     sweep_cap: int | None = None) -> dict:
    """Each case's wrapper arguments at the main-path shapes of ``cfg``
    (``LoamConfig.preset("VLP-16")`` at datasheet capacities by default)
    with sweeps padded to ``sweep_cap`` rows (the capacity of the full
    cloud by default). A ``LoamConfig.sized_for_stream`` config and
    ``config.stream_cap`` give the sized shapes: at the bench's VLP-16
    stream (14,464 rows, P = 1,152) K1 16 x 4 x 1,152 and K2 96 rows x
    256. At VLP-16: K1 16 rings x 4 columns x P=2048 of a 32,768-row sweep; K2
    96 (ring, region) rows x 384, corner (96 steps) and flat (64); K3
    corner 256 queries x 1,920 rows and surf 384 x 8,192; K4 16 (corner)
    and 32 (surf) groups of 128 queries x windows of 1,024 rows. At
    HDL-64E: K1 64 x 4 x 2,304 of 147,456 rows; K2 384 rows x 512; K3
    768 x 7,680 and 1,536 x 16,384; K4 the same (the mapping capacities
    do not depend on the preset)."""
    cfg = cfg or LoamConfig.preset("VLP-16")
    reg, caps, m = cfg.registration, cfg.capacities, cfg.mapping
    n_rings, p_cap = cfg.lidar.n_rings, cfg.lidar.max_points_per_ring
    sweep_cap = sweep_cap or caps.full_cloud
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}

    cols = t(rng.normal(size=(4, sweep_cap + p_cap)).astype(np.float32))
    starts = np.sort(rng.integers(0, sweep_cap, size=n_rings)).astype(np.int32)
    starts[0], starts[-1] = 0, sweep_cap
    out["grid"] = (cols, t(starts), p_cap)

    # One row per (ring, region) window, as wide as the engine's windows
    # (ops/features.py::_windows: the longest region plus the +-C spill).
    rows = n_rings * reg.n_feature_regions
    c, j = reg.curvature_region, reg.n_feature_regions
    max_len = (p_cap - 1 - 2 * c + j - 1) // j + 1
    w = min(-(-(max_len + 2 * c) // 128) * 128, p_cap)
    curv = t(rng.exponential(0.1, size=(rows, w)).astype(np.float32))
    picked0 = t(rng.random((rows, w)) < 0.1)
    left = t(rng.integers(0, 6, size=(rows, w)).astype(np.int32))
    right = t(rng.integers(0, 6, size=(rows, w)).astype(np.int32))
    in_region = t(rng.random((rows, w)) < 0.9)
    for name, corner, steps, quota, sharp in (
            ("greedy_corner", True, reg.corner_scan_cap,
             reg.max_corner_less_sharp, reg.max_corner_sharp),
            ("greedy_flat", False, reg.flat_scan_cap, reg.max_surface_flat, 0)):
        scores = torch.where(in_region & ~picked0, curv if corner else -curv,
                             float("-inf"))
        top, cand = torch.sort(scores, dim=1, descending=True, stable=True)
        out[name] = (curv, cand[:, :steps].to(torch.int32).contiguous(),
                     torch.isfinite(top[:, :steps]).contiguous(), picked0,
                     left, right, reg.surface_curvature_threshold, quota,
                     sharp, corner)

    for name, surf, nq, n_ref in (("corresp_corner", False, caps.sharp,
                                   caps.less_sharp),
                                  ("corresp_surf", True, caps.flat,
                                   caps.less_flat)):
        q = t((rng.normal(size=(nq, 3)) * 5).astype(np.float32))
        ref = t((rng.normal(size=(n_ref, 3)) * 5).astype(np.float32))
        ring = t(rng.integers(0, n_rings, size=n_ref).astype(np.int32))
        mask = rng.random(n_ref) < 0.8
        mask[n_ref // 2:] = False                  # padded tail, as in use
        out[name] = (q, ref, ring, t(mask), cfg.odometry.ring_bracket, surf)

    win, g = m.knn_window, m.knn_group
    for name, cap in (("knn_corner", m.corner_stack_capacity),
                      ("knn_surf", m.surf_stack_capacity)):
        tg = cap // g
        cloud = (rng.normal(size=(tg * win, 3)) * 5).astype(np.float32)
        cloud = cloud[np.argsort(cloud[:, 2], kind="stable")]
        windows = cloud.reshape(tg, win, 3)
        qg = windows[:, ::win // g] + rng.normal(size=(tg, g, 3)) * 0.3
        out[name] = (t(qg.astype(np.float32)), t(windows), 5)
    return out


LANE_SUFFIX = "_lanes"


def lane_inputs(dev: torch.device, seed: int = 0,
                cfg: LoamConfig | None = None, lanes: int = 8) -> dict:
    """The lane forms' arguments: each main-path case drawn ``lanes``
    times (seeds ``seed`` .. ``seed + lanes - 1``) and stacked on a
    leading lane axis, under the case's name + ``_lanes`` (at VLP-16 and
    B = 8: K1 cols (8, 4, 34,816), starts (8, 16); K2 (8, 96, 384); K3
    8 x 256 x 1,920 and 8 x 384 x 8,192; K4 (8, 16 / 32, 128, 3) against
    (8, 16 / 32, 1,024, 3))."""
    per = [main_path_inputs(dev, seed + i, cfg) for i in range(lanes)]
    return {case + LANE_SUFFIX: tuple(
                torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                else vals[0] for vals in zip(*(p[case] for p in per)))
            for case in per[0]}


def lane(args: tuple, i: int) -> tuple:
    """Lane i of a lane form's arguments."""
    return tuple(a[i] if isinstance(a, torch.Tensor) else a for a in args)


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def work(case: str, args: tuple) -> tuple[int, int]:
    """(operations, bytes) a call needs on these inputs: each input byte
    read once, each output byte written once, and only the operations
    this data asks for. A lane form's work is the sum of its lanes'."""
    if case.endswith(LANE_SUFFIX):
        per = [work(case[:-len(LANE_SUFFIX)], lane(args, i))
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
        # Per candidate step: the threshold, picked and quota tests and
        # the count. The pick reads curv only at the distinct usable
        # candidates of a row and left/right only at the picks (those of
        # the plain version on the same inputs); the candidates, picked0
        # and the outputs, labels (int32) and marks (bool), whole.
        ops = 4 * cand.numel()
        at_cand = torch.zeros((rows, w), dtype=torch.bool, device=curv.device)
        at_cand.scatter_(1, cand.long(), ok)
        labels, _ = greedy_kernel.greedy_pick_rows_plain(*args)
        n_picks = int((labels != 0).sum())
        read = (4 * int(at_cand.sum()) + 8 * n_picks
                + _nbytes(cand, ok, picked0))
        return ops, read + rows * w * 5
    if case.startswith("corresp"):
        q, ref, ring, mask, bracket, surf = args
        nq, m = q.shape[0], ref.shape[0]
        # Pass 1 scans the valid rows; pass 2 computes a distance only
        # for the valid rows in j's bracket (and, in surf mode, on j's
        # ring), for the queries that have a j at all.
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


def bound(case: str, args: tuple) -> dict:
    """The least time an H100 could take for the call: the larger of its
    operations over the float32 peak and its bytes over the memory
    rate."""
    ops, nbytes = work(case, args)
    ops_ms, bytes_ms = 1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def time_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up,
    by CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Host time to enqueue one call of ``fn`` (no synchronization in
    the loop), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn`` with no host time in the way:
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


def device_profile(fn, reps: int = 20, attempts: int = 3) -> dict:
    """What ``fn`` puts on the device per call, from ``torch.profiler``
    over ``reps`` calls after a warm-up: the number of device operations
    (kernels, memsets, copies), the sum of their durations (which leaves
    out the gaps between them) and that sum by operation name. The
    profiler now and then drops device events, which only lowers the
    count, so the attempt that saw the most is kept."""
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(events) > len(best):
            best = events
    by_op = {}
    for e in best:
        by_op[e.name] = (by_op.get(e.name, 0.0)
                         + (e.time_range.end - e.time_range.start) / reps / 1e3)
    return {"device_ops_per_call": len(best) / reps,
            "device_ms": sum(by_op.values()), "device_ms_by_op": by_op}
