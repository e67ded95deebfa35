"""Run one cell of the benchmark once, on the card.

    python3 -m loam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. A run:

1. sets up: the card, the kernels' library (built into the checkout's
   ``build/`` on first use), the cell's sweeps made on the card from the
   seed, and the graphs captured by warm-up calls;
2. measures a closed loop of the cell's entry for ``--seconds``;
3. checks what the window produced against the reference
   (``check.py``, ``oracle.py``), once the window has closed, its memory
   peak has been read and the program's state is freed;
4. prints each lane's ATE, the loss counters summed over the window and
   what the host did in it (the CPU time stolen from this machine, the
   process's own CPU time), then on standard error each number compared
   with its limit, and as
   its last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics``, ``device`` and, with
   ``--trace 1``, ``breakdown``, then ``checks`` (the numbers compared).

With ``--trace 0`` the metrics are the cell's end-to-end metrics
(``sweeps_per_s``, ``latency_p95_ms`` where the cell times single
sweeps, ``setup_s``); with ``--trace 1`` its per-layer metrics, read by
``metrics/<name>.py`` from the window, the kernels' launch counters, a
profiled slice of the window and an eager replay of a few steps. It
exits non-zero, with no result, without enough cards, and when any
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PROCESS_T0 = time.time()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Kernel caches of the program, at fixed paths inside the checkout.
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "loam_bench", "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from loam_bench import check, spec, window  # noqa: E402
from loam_bench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "loam_velodyne_tpu")
TRACE_AFTER = 1 / 3           # of the window, before the profiled slice


def process_start() -> float:
    """When this process started (epoch s), from /proc; the module's
    import time where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return PROCESS_T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def launches() -> dict:
    """The K3 and K4 launches the port has counted so far (the card's
    counters settled into the wrappers)."""
    from loam_velodyne_torch.ops import corresp_kernel, knn_kernel, launches as l
    l.settle()
    return {"k3": corresp_kernel.corresp_search.launches,
            "k4": knn_kernel.grouped_window_knn.launches}


class Readings:
    """What a per-layer metric's reader may read."""

    def __init__(self, window_, launches_, profile, roofline_):
        self.window, self.launches = window_, launches_
        self.profile, self.roofline = profile, roofline_


def host_times() -> tuple:
    """(the machine's stolen CPU time, this process's CPU time), in s."""
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        steal = float("nan")
    t = os.times()
    return steal, t.user + t.system


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> dict:
    """One run of ``cell``: the result's fields, and the lines printed
    before it (``lines``) and the check's lines (``check_lines``). With
    ``control`` the program runs its float32 matrix products in TF32 (the
    check's control)."""
    from loam_bench.entry import LOSS_NAMES
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    device = torch.device(device)
    on_card = device.type == "cuda"
    entry = cell.entry(cell, seed, device)
    entry.setup()
    if on_card:
        torch.cuda.synchronize(device)
    base = launches()
    step = entry.step
    tracer = None
    if trace:
        tracer = Tracer(step, device, TRACE_AFTER * seconds,
                        int(cell.traffic["trace_steps"]))
        step = tracer
    entry.open_window()
    setup_s = time.time() - t_start
    host0 = host_times()
    w = window.measure(step, seconds)
    host1 = host_times()
    entry.close_window()
    counted = launches()
    used = {k: counted[k] - base[k] for k in base}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    profile = tracer.reduce() if tracer is not None else None
    roof = None
    if trace and on_card:
        from loam_bench import roofline
        with roofline.recording() as calls:
            entry.eager_replay()
        roof = roofline.share(calls)
    lines = entry.ate_lines()
    loss = dict(zip(LOSS_NAMES, (int(x) for x in entry.loss)))
    lines.append("loss counters over the window: " + json.dumps(loss))
    lines.append(f"host over the window of {w.seconds:.3f} s: stolen CPU "
                 f"{host1[0] - host0[0]:.2f} s, this process's CPU "
                 f"{host1[1] - host0[1]:.2f} s")
    d = sorted(w.durations)
    lines.append(f"calls in the window: {w.calls}, ms a call p10 "
                 f"{1e3 * d[len(d) // 10]:.2f} p50 {1e3 * d[len(d) // 2]:.2f} "
                 f"p90 {1e3 * d[9 * len(d) // 10]:.2f} max {1e3 * d[-1]:.2f}; "
                 "by tenth of the window (ms a call): " + " ".join(
                     f"{1e3 * sum(x) / len(x):.2f}" for x in np.array_split(
                         np.asarray(w.durations), 10) if len(x)))
    samples = entry.sample_list()
    nonfinite = entry.nonfinite
    entry.release()
    del entry
    if on_card:
        torch.cuda.empty_cache()
    limits = cell.check["limits"]
    t_check = time.time()
    verdict = check.judge(samples, cell.config, limits,
                          int(cell.check.get("workers", 1)) if on_card else 1)
    check_s = time.time() - t_check
    if profile is not None:
        lines.append(
            "traced slice: {steps} steps, device busy {busy_s:.4f} s of "
            "{window_s:.4f} s (profiler flushes {profiler_s:.4f} s); the "
            "{unprofiled_steps} steps before it, unprofiled, "
            "{unprofiled_s:.4f} s".format(**profile))
    for label, nums in verdict["samples"]:
        lines.append(f"sample {label}: " + json.dumps(nums))

    if trace:
        r = Readings(w, used, profile, roof)
        metrics = {}
        for m in cell.per_layer:
            v = m.read(r)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        metrics = {"sweeps_per_s": {"value": window.rate(w),
                                    "unit": "sweeps/s"}}
        if any(m.name == "latency_p95_ms" for m in cell.end_to_end):
            metrics["latency_p95_ms"] = {"value": 1e3 * window.p95(w.latencies),
                                         "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    failed = nonfinite + verdict["failed"]
    if verdict["missing"]:
        lines.append("no sample of kind " + ", ".join(verdict["missing"]))
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"] and nonfinite == 0,
           "attempted": w.lane_sweeps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        out["breakdown"] = {"device_ops": profile["device_ops_by_time"],
                            "idle_gaps": profile["idle_gaps"]}
    out["checks"] = {k: {"value": verdict["numbers"][k], "limit": limits[k]}
                     for k in check.NUMBERS}
    check_lines = [f"check {k}: {verdict['numbers'][k]!r} limit {limits[k]!r}"
                   for k in check.NUMBERS]
    return {"result": out, "lines": lines, "check_lines": check_lines,
            "samples": verdict["samples"],
            "window": w, "launches": used, "profile": profile,
            "roofline": roof, "check_s": check_s}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m loam_bench.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    t_start = process_start()
    cell = spec.plan(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line)
    print(f"check took {out['check_s']:.1f} s")
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
