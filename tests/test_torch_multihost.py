"""Port parity, the multi-process replay: loam_velodyne_torch.parallel.
multihost (lanes sharded over processes, one gloo all_gather of the
trajectories at the end) and its two-process dry run
(``python -m loam_velodyne_torch.tools.dryrun_dcn``), on the CPU.

The reference is the JAX package, run once on the dry run's four lanes
(``tests/multihost_jax.npz``, written by
``python tests/test_torch_trajectory_gates.py multihost``): its static
``make_batched_chunk`` in the dry run's chunks, and its
``replay_sequences`` on a one-CPU mesh, which runs the dynamic batched
step (``engine.step`` with its dynamic cadence and Gauss-Newton
schedules under ``jax.vmap``). The port's batched step takes the same
decisions on the device (each lane's gate and first sweep; each GN in
the static schedule's phases, which give the dynamic schedule's
transform bit for bit); the JAX package's two runs of this input are
equal to the bit.

Tolerances: positions to 1e-5 against either JAX run (measured largest
deviation: 8.6e-7 for both, growing over the 8 sweeps; the lanes are on
the 1/128 m grid, where the port and the JAX package pick the same
features, so what is left is float32 rounding in the Gauss-Newton
solves). Within the dry run, exact: the two workers' gathered arrays,
and lane 0 of rank 0 against lane 0 of rank 1 (the same input).

The dry run's report is read from its file, not from standard output,
where gloo's warnings interleave.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from loam_velodyne_torch.parallel import multihost
from loam_velodyne_torch.parallel import replay as treplay
from loam_velodyne_torch.tools import dryrun_dcn

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFERENCE = os.path.join(HERE, "multihost_jax.npz")
TOL = 1e-5
LANES = dryrun_dcn.N_PROC * dryrun_dcn.LANES_PER_PROC


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _reference():
    with np.load(REFERENCE) as z:
        return z["chunked"], z["dynamic"]


def _lanes():
    """The dry run's four lanes, rank-major, and its config."""
    case = dryrun_dcn.tiny_case(0)
    return case.cfg, [lane for r in range(dryrun_dcn.N_PROC)
                      for lane in dryrun_dcn.tiny_case(r).lanes], case.cap


def test_reference_is_the_dry_runs_input_through_jax():
    """The committed JAX positions: four finite lanes of 8 sweeps that
    move (the tiny scene engages odometry), the two JAX runs equal."""
    chunked, dynamic = _reference()
    assert chunked.shape == dynamic.shape == (LANES, 8, 3)
    assert np.isfinite(chunked).all()
    np.testing.assert_array_equal(dynamic, chunked)
    assert np.abs(chunked).max() > 0.05


def test_tiny_preset_is_the_jax_dry_runs_config():
    """The tiny preset's config is the one tools/dryrun_dcn.py builds."""
    from loam_velodyne_tpu.config import LidarConfig
    from loam_velodyne_tpu.parallel.replay import tiny_config
    want = dataclasses.replace(
        tiny_config(),
        lidar=LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=512),
        capacities=None)
    got = dryrun_dcn.tiny_case(0).cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_two_process_dry_run_gathers_every_lane(tmp_path):
    """Two gloo processes, two lanes each: every process receives all
    four lanes, lane 0 is equal across processes, and the lanes are the
    JAX package's static batched chunk on the same input."""
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "loam_velodyne_torch.tools.dryrun_dcn",
         "--device", "cpu", "--preset", "tiny", "--out", str(out),
         "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        report = json.load(f)
    assert report["ok"] and report["processes"] == 2
    assert [w["rank"] for w in report["workers"]] == [0, 1]
    pos = [np.asarray(w["positions"], np.float32) for w in report["workers"]]
    assert all(p.shape == (LANES, 8, 3) for p in pos)
    assert report["gathered_equal"]
    np.testing.assert_array_equal(pos[0], pos[1])
    np.testing.assert_array_equal(pos[0][0], pos[0][dryrun_dcn.LANES_PER_PROC])
    assert report["lane0_max_abs_diff"] == 0.0
    # The plain versions ran: no kernel launched on the CPU.
    assert all(n == 0 for w in report["workers"] for n in w["launches"].values())
    assert all(len(w["chunk_seconds"]) == 2 for w in report["workers"])
    chunked, _ = _reference()
    np.testing.assert_allclose(pos[0], chunked, rtol=0, atol=TOL)


def test_batched_step_matches_the_jax_dynamic_batched_step():
    """The port's ``replay_sequences`` (the batched step, each lane's
    decisions taken on the device) on the dry run's four lanes against
    the JAX package's (the dynamic schedules under vmap)."""
    cfg, lanes, cap = _lanes()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the tiny shapes run faster on one
    try:
        pos = treplay.replay_sequences(cfg, lanes, device="cpu",
                                       sweep_capacity=cap)
    finally:
        torch.set_num_threads(threads)
    _, dynamic = _reference()
    np.testing.assert_allclose(pos, dynamic, rtol=0, atol=TOL)


_REFUSALS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from loam_velodyne_torch.parallel import multihost
    from loam_velodyne_torch.parallel.replay import tiny_config
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    multihost.init(f"localhost:{port}", 2, rank)
    cfg = tiny_config()
    sweep = np.zeros((16, 3), np.float32)
    errors = []
    for lanes, t, chunk in ((1 + rank, 4, 4), (2, 6, 4), (2, 4, 4)):
        try:
            multihost.replay_global(cfg, [[sweep] * t] * lanes, chunk=chunk,
                                    device="cuda")
            errors.append(None)
        except (ValueError, RuntimeError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    json.dump(errors, open(out, "w"))
""")


def test_replay_global_refuses_unequal_lanes_and_partial_chunks(tmp_path):
    """Both processes refuse, before any sweep runs: unequal lane counts
    (1 against 2), a length that is not a multiple of the chunk (6 of
    4), and a CUDA device where there is none. The store's port is held
    until both have exited (``dryrun_dcn.reserved_port``)."""
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    with dryrun_dcn.reserved_port() as port:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _REFUSALS, str(r), str(port), str(outs[r])],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-4000:]
    for out in outs:
        with open(out) as f:
            errors = json.load(f)
        assert errors[0].startswith("ValueError: unequal lane counts"), errors
        assert errors[1].startswith("ValueError: sequence length 6"), errors
        if torch.cuda.is_available():
            assert errors[2] is None, errors
        else:
            assert errors[2].startswith("RuntimeError: no CUDA device"), errors


def test_replay_global_chooses_the_card_by_default():
    """Without ``device`` the process's card is chosen
    (``cuda:{rank % device_count}``); without a card, an error."""
    with dryrun_dcn.reserved_port() as port:
        multihost.init(f"localhost:{port}", 1, 0)
    try:
        if torch.cuda.is_available():
            assert multihost.default_device() == torch.device("cuda:0")
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.default_device()
    finally:
        dist.destroy_process_group()
