"""The deliberate divergences, measured against the reference oracle:

    python -m loam_velodyne_torch.tools.oracle_ab [n_sweeps=30] [--device cuda]

Counterpart of ``tools/oracle_ab.py``: ``n_sweeps`` noisy turning sweeps
(``synthetic.bench_sweeps``) through the NumPy reference oracle
(``tests/reference_oracle.py``, the reference C++ pipeline transliterated),
then through the port's ``LoamDriver`` under each divergence toggle,
printing the cross-ATE of each variant:
- ``default``: the VLP-16 preset;
- ``refresh1``: mapping ``corresp_refresh_every=1`` (the reference's
  refresh every GN iteration);
- ``budget125``: the active-cube budget off (all 125 neighbourhood cubes);
- ``refresh1+budget125``: both.

The oracle's fused poses come from the committed
``tests/oracle_trajectory.npz`` where it holds ``n_sweeps`` sweeps (10
and 30). Otherwise the oracle runs (sequential NumPy, minutes) and its
poses are cached as ``oracle_ab_<n>.npz`` in the temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.eval.metrics import ate_rmse
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.models.engine import require_device

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests")
COMMITTED = os.path.join(TESTS, "oracle_trajectory.npz")


def variants(base: LoamConfig) -> dict:
    """The four configs, by name: ``base`` and its divergence toggles."""
    def mapping(**kw):
        return dataclasses.replace(base, mapping=dataclasses.replace(
            base.mapping, **kw))

    budget = {"max_active_cubes": 125, "thin_active_cubes": 125}
    return {"default": base,
            "refresh1": mapping(corresp_refresh_every=1),
            "budget125": mapping(**budget),
            "refresh1+budget125": mapping(corresp_refresh_every=1, **budget)}


def oracle_fused(sweeps: list) -> np.ndarray:
    """The oracle's (n, 6) fused poses on ``sweeps`` (the first n of the
    bench sequence): committed, cached, or run and cached."""
    n = len(sweeps)
    with np.load(COMMITTED) as ref:
        if f"fused_{n}" in ref.files:
            return ref[f"fused_{n}"]
    cache = os.path.join(tempfile.gettempdir(), f"oracle_ab_{n}.npz")
    if os.path.exists(cache):
        with np.load(cache) as c:
            return c["fused"]
    sys.path.insert(0, TESTS)
    from reference_oracle import OraclePipeline
    fused = OraclePipeline().run(sweeps)
    np.savez(cache, fused=fused)
    return fused


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m loam_velodyne_torch.tools.oracle_ab")
    p.add_argument("n_sweeps", nargs="?", type=int, default=30)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = require_device(args.device)
    sweeps, gt = synthetic.bench_sweeps(args.n_sweeps)
    fused = oracle_fused(sweeps)[:, 3:]
    print(f"oracle-vs-gt ATE {ate_rmse(fused, gt, align=True):.4f} m", flush=True)
    out = {}
    for name, cfg in variants(LoamConfig.preset("VLP-16")).items():
        est = LoamDriver(cfg, device, system_delay=0).run(sweeps)
        cross = ate_rmse(est, fused, align=True)
        vs_gt = ate_rmse(est, gt, align=True)
        out[name] = {"cross_ate_m": cross, "ate_m": vs_gt}
        print(f"{name:22s} repo-vs-oracle {cross:.4f} m | repo-vs-gt "
              f"{vs_gt:.4f} m", flush=True)
    return out


if __name__ == "__main__":
    main()
