"""Two readings of the static chunk that the CUDA graphs rest on.

``--syncs``: one static chunk (after a warm-up chunk) on the single
stream and on B lanes, eager and through the CUDA graphs, and two
per-sweep steps through the per-sweep graphs (after two that captured
them), under ``torch.cuda.set_sync_debug_mode("warn")``; every
synchronizing call is listed with the port's frames that made it (a
graph cannot capture one, and the graphed forms decide the GN's stop
on the card, so none of them may read back).

``--eigh``: the eager 48-sweep replay of the bench sequence (VLP-16,
chunks of 8) with the degeneracy projector's eigendecomposition in
each of three forms, against the JAX package's replay of the same
sequence (``tests/bench_trajectory_jax.npz``): aligned cross-ATE of the
fused positions, the largest pose deviation (by chunk), the ATE
against the simulator, and each form's deviation from the first on
sweeps 0-7 (where rounding-equivalent forms part). The forms: ``eigh`` (``torch.linalg.eigh`` in
float32, as the port before the Jacobi; it reads back on the card),
``jacobi32`` (``utils/linalg.py::jacobi_eigh`` in float32) and
``jacobi64`` (the Jacobi in float64 rounded to float32, the port's
``degeneracy_projector``).

Prints one JSON object as its last line.

    python3 -m loam_velodyne_torch.tools.static_path_probe --syncs --eigh
    python -m loam_velodyne_torch.tools.static_path_probe --eigh --device cpu
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import warnings

import numpy as np
import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.eval.metrics import ate_rmse
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import mapping as mapping_mod
from loam_velodyne_torch.models import odometry as odometry_mod
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay
from loam_velodyne_torch.utils import linalg

CHUNK, SWEEPS, SWEEP_CAP, LANES = 8, 48, 32768, 8
JAX_REPLAY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "bench_trajectory_jax.npz")


def _eigh32(a):
    return torch.linalg.eigh(a)


def _jacobi32(a):
    return linalg.jacobi_eigh(a)


def _jacobi64(a):
    w, v = linalg.jacobi_eigh(a.double())
    return w.float(), v.float()


FORMS = {"eigh": _eigh32, "jacobi32": _jacobi32, "jacobi64": _jacobi64}


@contextlib.contextmanager
def projector_with(eigh):
    """``degeneracy_projector`` (odometry's and mapping's) with its
    eigendecomposition replaced by ``eigh`` inside the block."""
    def projector(ata, threshold):
        w, v = eigh(ata)
        keep = (w >= threshold).to(torch.float32)
        return (v * keep[None, :]) @ v.T, (keep < 0.5).any()

    saved = odometry_mod.degeneracy_projector
    odometry_mod.degeneracy_projector = mapping_mod.degeneracy_projector = projector
    try:
        yield
    finally:
        odometry_mod.degeneracy_projector = mapping_mod.degeneracy_projector = saved


def eager_replay(cfg, xyz, mask) -> np.ndarray:
    """The eager static chunks from a fresh state: (n, 29) packed rows."""
    state, cadence, rows = (engine_mod.EngineState.create(cfg, xyz.device),
                            engine_mod.Cadence(), [])
    for s in range(0, xyz.shape[0], CHUNK):
        state, outs = engine_mod.run_chunk(
            state, RawSweep(xyz[s:s + CHUNK], mask[s:s + CHUNK]), cfg, cadence)
        for _ in range(CHUNK):
            cadence = cadence.advance(cfg)
        rows.append(outs.packed)
    return torch.cat(rows).cpu().numpy()


def eigh_forms(dev: torch.device) -> dict:
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, gt = synthetic.bench_sequence(SWEEPS, cfg.lidar, SWEEP_CAP)
    xyz, mask = torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)
    with np.load(JAX_REPLAY) as z:
        ref = z["poses"]
    out, first = {}, None
    for name, eigh in FORMS.items():
        t0 = time.perf_counter()
        with projector_with(eigh):
            packed = eager_replay(cfg, xyz, mask)
        first = packed if first is None else first
        dev_by_sweep = np.abs(packed[:, :18] - ref[:, :18]).max(axis=1)
        out[name] = {
            "seconds": time.perf_counter() - t0,
            "ate_cm": 100 * ate_rmse(packed[:, 15:18], gt, align=True),
            "cross_ate_cm": 100 * ate_rmse(packed[:, 15:18], ref[:, 15:18],
                                           align=True),
            "max_dev": float(dev_by_sweep.max()),
            "max_dev_by_chunk": [float(dev_by_sweep[s:s + CHUNK].max())
                                 for s in range(0, SWEEPS, CHUNK)],
            "telemetry": packed[:, 20:28].sum(0).tolist(),
            # Where the forms part: against the first form, sweeps 0-7.
            "dev_from_eigh_by_sweep": np.abs(
                packed[:CHUNK, :18] - first[:CHUNK, :18]).max(axis=1).tolist()}
        print(f"eigh {name}: {json.dumps(out[name])}", flush=True)
    return out


def _sites_of(call, dev: torch.device) -> dict:
    """The synchronizing calls that ``call()`` makes, by call site (the
    port's three innermost frames)."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "loam_velodyne_torch" in f.filename
                  and not f.filename.endswith("static_path_probe.py")]
        sites[" <- ".join(f"{f.filename.split('loam_velodyne_torch/')[-1]}:"
                          f"{f.lineno}" for f in frames[::-1][:3])] += 1

    engine_mod.sync(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    engine_mod.sync(dev)
    return {k: v for k, v in sites.items() if k}


def sync_sites(dev: torch.device) -> dict:
    """Synchronizing calls of one static chunk of 2 sweeps after a
    warm-up chunk, single stream and LANES lanes, eager and (on the card)
    through the CUDA graphs, and of two per-sweep steps through the
    per-sweep graphs after two that captured them, by call site. Inside
    the graphed forms the GN's stop is decided on the card (conditional
    nodes): none may read back."""
    cfg = LoamConfig.preset("VLP-16")
    xyz, mask, _ = synthetic.bench_sequence(4, cfg.lidar, SWEEP_CAP)
    xyz, mask = torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)
    lx = xyz[None].expand(LANES, -1, -1, -1).contiguous()
    lm = mask[None].expand(LANES, -1, -1).contiguous()
    first, second = slice(0, 2), slice(2, 4)
    batched = replay.make_eager_batched_chunk(cfg)
    out = {}

    def chunks(name, chunk, state, x, m):
        ax = x.dim() - 3                       # the sweep axis
        part = (lambda t, s: t.narrow(ax, s.start, 2))  # noqa: E731
        state, _ = chunk(state, part(x, first), part(m, first),
                         engine_mod.Cadence())
        out[name] = _sites_of(lambda: chunk(state, part(x, second),
                                            part(m, second),
                                            engine_mod.Cadence(2, 1, True)),
                              dev)

    chunks("single", lambda s, x, m, c: engine_mod.run_chunk(
        s, RawSweep(x, m), cfg, c), engine_mod.EngineState.create(cfg, dev),
        xyz, mask)
    chunks("lanes", lambda s, x, m, c: batched(s, RawSweep(x, m), c),
           replay.create_states(cfg, LANES, dev), lx, lm)
    if dev.type == "cuda":
        engine = engine_mod.Engine(cfg, dev)
        engine.run_chunk(xyz[first], mask[first])
        out["single_graphed"] = _sites_of(
            lambda: engine.run_chunk(xyz[second], mask[second]), dev)
        graphed = replay.make_batched_chunk(cfg)
        chunks("lanes_graphed",
               lambda s, x, m, c: graphed(s, RawSweep(x, m), c),
               replay.create_states(cfg, LANES, dev), lx, lm)
        engine = engine_mod.Engine(cfg, dev)
        for i in range(2):
            engine.step(xyz[i], mask[i])
        out["per_sweep_graphed"] = _sites_of(
            lambda: [engine.step(xyz[i], mask[i]) for i in range(2, 4)], dev)
    for name, sites in out.items():
        print(f"syncs {name}: {json.dumps(sites)}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--syncs", action="store_true")
    ap.add_argument("--eigh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = engine_mod.require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": (engine_mod.card() if dev.type == "cuda" else "cpu"),
              "torch": torch.__version__}
    if args.syncs:
        result["syncs"] = sync_sites(dev)
    if args.eigh:
        result["eigh"] = eigh_forms(dev)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
