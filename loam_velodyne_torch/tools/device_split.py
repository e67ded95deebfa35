"""Where the card and the CPU part on one sweep of the IMU run.

Steps chip_smoke's live IMU input (the VLP-16 bench sweeps, and a
driver whose IMU tracker holds the rocking stream of
``io/synthetic.imu_stream`` for chip_smoke's LIVE_SWEEPS sweeps, built
by ``imu_driver`` for both) through ``LoamDriver.process_sweep`` on the
card and on the CPU for ``--before`` sweeps, saves the card's engine
state, loads it into a driver on the card and one on the CPU, and steps
the next sweep on both, every sweep with the eager step (``eager_steps``). The card's step records every call of the
functions in ``TRACED`` (arguments and outputs, copied to the host);
each is then replayed on the CPU with the card's inputs. A function
whose replay differs by more than rounding is where a split is born:
given the same inputs, the two devices disagree.

Floats are compared by their largest absolute difference, integers and
booleans by the number of elements that differ. For the line and plane
fits it also gives, for the rows whose replay differs, how well posed
each fit is (``fit_rows``) beside all rows.

    python3 -m loam_velodyne_torch.tools.device_split [--before 3]

Writes a JSON report (by default ``build/device_split/split_<before>.json``
at the repository root) and prints a summary. Runs on the card unless
``--device cpu``, a rehearsal in which every deviation is 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.ops import features, fit
from loam_velodyne_torch.ops import imu as imu_ops
from loam_velodyne_torch.ops import scan as scan_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP_CAP = 32768
# chip_smoke's LIVE_SWEEPS: the length of the IMU stream its live run
# pushes into the tracker before the first sweep. The tracker keeps the
# last imu_history_size samples, so the length decides the input.
STREAM_SWEEPS = 24

# (module, attribute): the functions whose calls are recorded, from the
# stages down to the fits and solves inside them.
TRACED = [
    (scan_mod, "ingest_sweep"), (engine_mod, "extract_features"),
    (features, "ring_curvature"), (features, "ring_rejection_mask"),
    (features, "suppression_extents"), (features, "_all_labels"),
    (features, "greedy_pick_rows"), (features, "_assemble_features"),
    (features, "voxel_downsample"),
    (imu_ops, "sweep_state"), (imu_ops, "end_attitude"),
    (odometry_mod, "step"), (odometry_mod, "corner_correspondences_fused"),
    (odometry_mod, "surf_correspondences_fused"),
    (odometry_mod, "_jacobian_rows"), (odometry_mod, "solve_gn"),
    (odometry_mod, "degeneracy_projector"),
    (mapping_mod, "step"), (mapping_mod, "voxel_downsample"),
    (mapping_mod, "assemble_map_cloud"), (mapping_mod, "optimize_pose"),
    (mapping_mod, "sort_cloud"), (mapping_mod, "tiled_windowed_knn"),
    (fit, "line_fit"), (fit, "plane_fit"), (mapping_mod, "_jacobian_rows"),
    (mapping_mod, "solve_gn"), (mapping_mod, "degeneracy_projector"),
]


def _host(x):
    """A copy of a tree of tensors on the host (other leaves as they are)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    return []


def deviation(a, b) -> dict:
    """Largest float difference and the count of differing integer or
    boolean elements between two trees of host tensors, over all leaves
    and leaf by leaf (``leaves``: a float difference beside the leaf's
    largest magnitude, or a count of differing elements)."""
    fl, n_int, leaves = 0.0, 0, []
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return {"float": float("inf"), "int": -1, "leaves": []}
    for x, y in zip(la, lb):
        if x.shape != y.shape:
            return {"float": float("inf"), "int": -1, "leaves": []}
        if x.dtype.is_floating_point:
            x, y = x.double(), y.double()
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            d = torch.where(same, 0.0, (x - y).abs())
            dm = float(d.max()) if d.numel() else 0.0
            finite = x[torch.isfinite(x)]
            scale = float(finite.abs().max()) if finite.numel() else 0.0
            fl = max(fl, dm)
            leaves.append([dm, scale])
        else:
            n = int((x != y).sum())
            n_int += n
            leaves.append(n)
    return {"float": fl, "int": n_int, "leaves": leaves}


class Recorder:
    """Wraps the TRACED functions; records (name, args, kwargs, outputs)
    on the host while ``on``, each tree copied by ``host``."""

    def __init__(self, host=_host):
        self.calls: list = []
        self.on = False
        self.originals = {}
        self.host = host

    def install(self):
        for mod, name in TRACED:
            fn = getattr(mod, name)
            self.originals[(mod, name)] = fn
            label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
            setattr(mod, name, self._wrap(label, fn))

    def remove(self):
        for (mod, name), fn in self.originals.items():
            setattr(mod, name, fn)

    def _wrap(self, label, fn):
        def recorded(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            entry = [label, fn, self.host(args), self.host(kwargs)]
            self.calls.append(entry)          # in call order, nested ones after
            out = fn(*args, **kwargs)
            entry.append(self.host(out))
            return out
        return recorded

    def run(self, body):
        self.calls, self.on = [], True
        try:
            body()
        finally:
            self.on = False
        return self.calls


def fit_rows(label: str, args, got, want) -> dict:
    """For a line or plane fit: the rows whose direction or normal, or
    validity, differ between the card and the CPU replay, with a measure
    of how well posed each row's fit is (float64), over those rows and
    over all: for the plane the condition of its normal equations
    A n = -1, for the line the ratio of the covariance's two largest
    eigenvalues (valid above ``line_eigen_ratio``)."""
    nbrs = args[0].double()
    if label.endswith("plane_fit"):
        m = (nbrs[..., :, :, None] * nbrs[..., :, None, :]).sum(-3)
        w = np.linalg.eigvalsh(m.numpy())
        stat = np.abs(w[..., -1]) / np.maximum(np.abs(w[..., 0]), 1e-300)
        name, vec_g, vec_w = "condition", got[0], want[0]
    else:
        d = nbrs - nbrs.mean(-2, keepdim=True)
        m = (d[..., :, :, None] * d[..., :, None, :]).sum(-3)
        w = np.linalg.eigvalsh(m.numpy())
        stat = w[..., 2] / np.maximum(w[..., 1], 1e-300)
        name, vec_g, vec_w = "eig_ratio", got[1], want[1]
    # A direction and its negative are the same line.
    dv = torch.minimum((vec_g - vec_w).abs().amax(-1),
                       (vec_g + vec_w).abs().amax(-1))
    rows = ((dv > 1e-3) | (got[-1] != want[-1])).numpy()
    out = {"rows": int(rows.size), "rows_differing": int(rows.sum()),
           "valid_differing": int((got[-1] != want[-1]).sum()),
           f"{name}_median_all": float(np.median(stat))}
    if rows.any():
        c = stat[rows]
        out.update({f"{name}_min_differing": float(c.min()),
                    f"{name}_median_differing": float(np.median(c)),
                    f"{name}_max_differing": float(c.max()),
                    "max_direction_difference": float(dv[rows].max())})
    return out


@contextlib.contextmanager
def eager_steps():
    """Inside the block every ``Engine`` steps its sweeps with the eager
    step (the module function ``engine.step``, the plain reference) on
    every device, so a recorder of Python calls sees each call: on the
    card ``Engine.step`` replays CUDA graphs, which run without Python."""
    graphed = engine_mod.Engine._per_sweep

    def eager(engine, raw, imu_window):
        return engine_mod.step(engine.state, raw, engine.cfg, "auto",
                               engine.cadence, imu_window)

    engine_mod.Engine._per_sweep = eager
    try:
        yield
    finally:
        engine_mod.Engine._per_sweep = graphed


def imu_driver(cfg, device, stream_sweeps: int = STREAM_SWEEPS,
               **kw) -> LoamDriver:
    """chip_smoke's live IMU driver: a ``LoamDriver`` (no system delay)
    whose tracker has been fed the rocking stream for ``stream_sweeps``
    sweeps."""
    kw.setdefault("sweep_capacity", SWEEP_CAP)
    drv = LoamDriver(cfg, device, system_delay=0, **kw)
    drv.imu_tracker = ImuTracker(cfg.registration.imu_history_size)
    for t, rpy, acc in synthetic.imu_stream(stream_sweeps):
        drv.imu_tracker.push_state(t, rpy, acc)
    return drv


def _rows(drv) -> np.ndarray:
    """(sweeps, 18): odometry, mapped and fused pose of each sweep, the
    rows chip_smoke holds against the CPU."""
    return np.concatenate([np.stack(drv.odom_trajectory),
                           np.stack(drv.mapped_trajectory),
                           np.stack(drv.trajectory)], axis=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--before", type=int, default=3,
                   help="sweeps stepped on the card before the split sweep")
    p.add_argument("--device", default="cuda",
                   help="the device held against the CPU (cpu: a rehearsal, "
                        "every deviation 0)")
    p.add_argument("--out", help="the JSON report (default: "
                                 "build/device_split/split_<before>.json)")
    args = p.parse_args(argv)
    dev = engine_mod.require_device(args.device)
    cfg = LoamConfig.preset("VLP-16")
    with eager_steps():
        return _split(args, cfg, dev)


def _split(args, cfg, dev) -> int:
    n = args.before + 1
    xyz, mask, _ = synthetic.bench_sequence(n, cfg.lidar, SWEEP_CAP)
    sweeps = [xyz[i][mask[i]] for i in range(n)]
    stamps = [0.1 * k for k in range(n)]

    out = args.out or os.path.join(ROOT, "build", "device_split",
                                   f"split_{args.before}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    ckpt = os.path.join(ROOT, "build", "device_split", "state.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)

    card = imu_driver(cfg, dev)
    cpu_all = imu_driver(cfg, "cpu")
    for pts, s in zip(sweeps[:args.before], stamps):
        card.process_sweep(pts, s)
        cpu_all.process_sweep(pts, s)
    card.save_checkpoint(ckpt)

    rec = Recorder()
    rec.install()
    try:
        on_card = imu_driver(cfg, dev)
        on_card.load_checkpoint(ckpt)
        on_cpu = imu_driver(cfg, "cpu")
        on_cpu.load_checkpoint(ckpt)
        pts, s = sweeps[args.before], stamps[args.before]
        t0 = time.perf_counter()
        card_calls = rec.run(lambda: on_card.process_sweep(pts, s))
        on_cpu.process_sweep(pts, s)
        cpu_all.process_sweep(pts, s)
        trace = []
        for i, (label, fn, a, kw, got) in enumerate(card_calls):
            want = _host(fn(*a, **kw))      # the CPU with the card's inputs
            entry = {"i": i, "call": label, "replay": deviation(got, want)}
            if label.endswith(("line_fit", "plane_fit")):
                entry["fit"] = fit_rows(label, a, got, want)
            trace.append(entry)
        seconds = time.perf_counter() - t0
    finally:
        rec.remove()

    # Sweeps 0..before: the card (its state carried into on_card) against
    # the CPU run from the start.
    card_rows = np.concatenate([_rows(card), _rows(on_card)])
    from_start = np.abs(card_rows - _rows(cpu_all)).max(axis=1).tolist()
    split_row = float(np.abs(_rows(on_card) - _rows(on_cpu)).max())
    report = {"before": args.before, "device": (torch.cuda.get_device_name(dev)
                                         if dev.type == "cuda" else "cpu"),
              "stream_sweeps": STREAM_SWEEPS,
              "pose_dev_from_start": from_start,
              "split_sweep_from_common_state_max_dev": split_row,
              "calls": len(card_calls), "seconds": seconds, "trace": trace}
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"sweeps 0-{args.before}: card against CPU from the start, "
          f"largest pose deviation per sweep {from_start}")
    print(f"sweep {args.before} from the card's state after sweep "
          f"{args.before - 1}: card against CPU {split_row:.3g}; "
          f"{len(card_calls)} traced calls")
    for e in trace:
        r = e["replay"]
        line = f"{e['i']:4d} {e['call']:38s} replay {r['float']:.3g}/{r['int']}"
        if r["float"] or r["int"]:
            line += " replay leaves " + json.dumps(
                [v if isinstance(v, int) else [float(f"{x:.3g}") for x in v]
                 for v in r["leaves"]])
        if "fit" in e:
            line += " fit " + json.dumps(e["fit"])
        print(line)
    print(json.dumps({k: v for k, v in report.items() if k != "trace"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
