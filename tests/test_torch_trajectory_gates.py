"""Trajectory gates of the port, against committed references.

The card has no JAX, so every reference the card is held to is a file:
- ``tests/golden_trajectory.npz``: the JAX driver's 6-sweep VLP-16 run
  (tests/test_golden.py). The port's driver on the CPU is held to it
  here (slow), and on the card by ``chip_smoke.py``, both at that
  test's 2e-3, over the first GOLDEN_GATE_SWEEPS sweeps. From sweep 3,
  the second mapping frame, the JAX package itself no longer meets
  2e-3 on this repository's CPU build (measured: 0, 1.5e-5, 2.7e-5,
  2.8e-3, 2.8e-3, 2.4e-3 by sweep; the port: 0, 5.0e-4, 9.6e-4,
  2.5e-3, 2.3e-3, 6.2e-3), and a gate the reference fails cannot gate
  the port; the later sweeps are read and reported, not gated.
- ``tests/bench_trajectory_jax.npz``: the JAX package's static-cadence
  replay of the 48-sweep bench sequence (``synthetic.bench_sequence``)
  on the CPU, in chunks of 8, as ``bench.py::bench_single_stream``
  runs it: its 18 pose columns per sweep (odom, mapped, fused) and the
  ground truth. ``chip_smoke.py`` holds the card's replay to it by the
  aligned cross-ATE and the largest pose deviation. It also holds
  ``golden_driver``: the JAX driver's six fused poses on the golden's
  input on the CPU (tests/test_golden.py's run), which ``chip_smoke.py``
  prints beside the card's on the sweeps it does not gate. Write it with

      python tests/test_torch_trajectory_gates.py regen

  (JAX on the CPU, VLP-16 at datasheet capacities: 2.3 GB at its peak,
  a few minutes), or only ``golden_driver`` with ``... golden``, which
  prints the JAX driver's deviation from the golden by sweep.
- ``tests/oracle_trajectory.npz``: tests/reference_oracle.py's NumPy
  pipeline (the reference C++ pipeline, transliterated) on the inputs
  of tests/test_oracle.py's VLP-16 gates, 10 and 30 noisy turning
  sweeps: its fused poses and the ground truth. The port is held to
  those gates against it: its CPU driver here (slow), the card's in
  ``chip_smoke.py``. Write it with

      python tests/test_torch_trajectory_gates.py oracle

  (NumPy only, about 5 minutes).
- ``tests/multihost_jax.npz``: the JAX package on the four lanes of the
  port's tiny two-process dry run (tests/test_torch_multihost.py reads
  it); ``... multihost`` writes it (JAX on the CPU, about 5 minutes).
"""

import os
import sys

import numpy as np
import pytest
import torch

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_trajectory.npz")
BENCH = os.path.join(HERE, "bench_trajectory_jax.npz")
GOLDEN_TOL = 2e-3           # tests/test_golden.py's tolerance
N_GOLDEN = 6
GOLDEN_GATE_SWEEPS = 3      # the sweeps before the second mapping frame
N_BENCH, CHUNK, CAP = 48, 8, 32768
MULTIHOST = os.path.join(HERE, "multihost_jax.npz")
ORACLE = os.path.join(HERE, "oracle_trajectory.npz")
ORACLE_SWEEPS = (10, 30)    # tests/test_oracle.py's two VLP-16 gates
ORACLE_RECOMPUTED = 2       # the oracle's sweeps recomputed in tier-1


def golden_sweeps():
    """The golden's input (tests/test_golden.py::_replay), from the
    port's copy of the simulator."""
    from loam_velodyne_torch.io import synthetic
    sweeps, gt, _ = synthetic.generate_sequence(N_GOLDEN, n_azimuth=900,
                                                speed=1.0)
    return sweeps, gt


def port_golden_run(device="cpu") -> np.ndarray:
    """The port's driver on the golden's input: (6, 6) fused poses."""
    from loam_velodyne_torch.config import LoamConfig
    from loam_velodyne_torch.io.driver import LoamDriver
    drv = LoamDriver(LoamConfig.preset("VLP-16"), device=device,
                     system_delay=0)
    for pts in golden_sweeps()[0]:
        drv.process_sweep(pts)
    return np.stack(drv.trajectory)


def test_bench_reference_is_committed_and_sane():
    """The JAX bench reference: 48 sweeps of 18 finite pose columns,
    within 5 cm ATE of its ground truth, which is the port's simulator's."""
    from loam_velodyne_torch.config import LoamConfig
    from loam_velodyne_torch.eval.metrics import ate_rmse
    from loam_velodyne_torch.io import synthetic
    with np.load(BENCH) as ref:
        poses, gt = ref["poses"], ref["gt"]
    assert poses.shape == (N_BENCH, 18) and np.isfinite(poses).all()
    np.testing.assert_array_equal(
        gt, synthetic.generate_sequence(
            N_BENCH, LoamConfig.preset("VLP-16").lidar, n_azimuth=900,
            speed=1.0, noise_std=0.005,
            traj=synthetic.turning_trajectory(speed=1.0))[1].astype(gt.dtype))
    assert ate_rmse(poses[:, 15:18], gt, align=True) <= 0.05


def test_golden_reference_matches_the_port_simulator():
    """The golden's recorded ground truth is the port's simulator's."""
    with np.load(GOLDEN) as g:
        gt = g["gt"]
    np.testing.assert_allclose(golden_sweeps()[1], gt, rtol=0, atol=1e-12)


@pytest.mark.slow
def test_port_driver_matches_the_golden_trajectory():
    """LoamDriver(device="cpu") on the golden's input, to 2e-3 over the
    first GOLDEN_GATE_SWEEPS sweeps; all six finite."""
    with np.load(GOLDEN) as g:
        golden = g["trajectory"]
    traj = port_golden_run("cpu")
    assert traj.shape == golden.shape and np.isfinite(traj).all()
    k = GOLDEN_GATE_SWEEPS
    np.testing.assert_allclose(traj[:k], golden[:k], rtol=0, atol=GOLDEN_TOL)


def jax_bench_run():
    """The JAX package's static-cadence replay of the bench sequence on
    the CPU, chunks of 8: (poses (48, 18), gt (48, 3))."""
    import jax
    import jax.numpy as jnp
    from loam_velodyne_tpu.config import LoamConfig
    from loam_velodyne_tpu.io import synthetic
    from loam_velodyne_tpu.models import engine
    from loam_velodyne_tpu.ops.scan import RawSweep

    cfg = LoamConfig.preset("VLP-16")
    sweeps, gt, _ = synthetic.generate_sequence(
        N_BENCH, lidar=cfg.lidar, n_azimuth=900, speed=1.0, noise_std=0.005,
        traj=synthetic.turning_trajectory(speed=1.0))
    run = jax.jit(lambda s, r: engine.run_chunk(s, r, cfg, static_cadence=True))
    state = engine.EngineState.create(cfg)
    packed = []
    for s in range(0, N_BENCH, CHUNK):
        xyz = np.zeros((CHUNK, CAP, 3), np.float32)
        mask = np.zeros((CHUNK, CAP), bool)
        for i, pts in enumerate(sweeps[s:s + CHUNK]):
            xyz[i, :len(pts)], mask[i, :len(pts)] = pts[:CAP], True
        state, outs = run(state, RawSweep(jnp.asarray(xyz), jnp.asarray(mask)))
        packed.append(np.asarray(outs.packed))
    packed = np.concatenate(packed)
    return packed[:, :18], np.asarray(gt), packed[:, 20:28]


def jax_golden_run() -> np.ndarray:
    """The JAX driver on the golden's input, as tests/test_golden.py runs
    it: (6, 6) fused poses."""
    from loam_velodyne_tpu.config import LoamConfig
    from loam_velodyne_tpu.io import synthetic
    from loam_velodyne_tpu.io.driver import LoamDriver
    sweeps, _, _ = synthetic.generate_sequence(N_GOLDEN, n_azimuth=900,
                                               speed=1.0)
    drv = LoamDriver(LoamConfig.preset("VLP-16"), system_delay=0)
    for pts in sweeps:
        drv.process_sweep(pts)
    return np.stack(drv.trajectory)


def oracle_input(n: int):
    """The input of tests/test_oracle.py's VLP-16 gates: n noisy turning
    sweeps, from the port's copy of the simulator: (sweeps, gt (n, 3))."""
    from loam_velodyne_torch.io import synthetic
    return synthetic.bench_sweeps(n)


def oracle_run(sweeps) -> np.ndarray:
    """tests/reference_oracle.py's pipeline (NumPy only): (n, 6) fused
    poses."""
    from reference_oracle import OraclePipeline
    return OraclePipeline().run(sweeps)


def test_oracle_reference_is_the_oracle_on_the_port_simulator():
    """The committed oracle run: its ground truth is the port's
    simulator's on the same input, and its first ORACLE_RECOMPUTED
    fused poses are the oracle's, recomputed (float64 NumPy: to 1e-9)."""
    with np.load(ORACLE) as ref:
        files = {n: (ref[f"fused_{n}"], ref[f"gt_{n}"]) for n in ORACLE_SWEEPS}
    for n, (fused, gt) in files.items():
        assert fused.shape == (n, 6) and np.isfinite(fused).all()
        np.testing.assert_array_equal(gt, oracle_input(n)[1])
    sweeps, _ = oracle_input(ORACLE_RECOMPUTED)
    np.testing.assert_allclose(oracle_run(sweeps),
                               files[10][0][:ORACLE_RECOMPUTED], rtol=0,
                               atol=1e-9)


@pytest.mark.slow
def test_port_driver_within_the_oracle_gates():
    """LoamDriver(device="cpu") against the NumPy oracle, with
    tests/test_oracle.py's gates at 10 and 30 sweeps
    (``chip_smoke.oracle_gates``, which the card runs too)."""
    import torch

    import chip_smoke
    readings, failed = chip_smoke.oracle_gates(torch.device("cpu"))
    print(readings)
    assert not failed, failed


def jax_multihost_run():
    """The JAX package on the four lanes of the port's tiny two-process
    dry run (``loam_velodyne_torch/tools/dryrun_dcn.py --preset tiny``:
    ranks 0 and 1, lanes 0 and 1, on the 1/128 m grid), in one process
    on the CPU: (fused positions (4, 8, 3) of ``make_batched_chunk``,
    the static cadence, in the dry run's chunks; those of
    ``replay_sequences`` on a one-CPU mesh, the dynamic batched step;
    the chunk's telemetry counters)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from loam_velodyne_tpu.config import LidarConfig
    from loam_velodyne_tpu.models import engine
    from loam_velodyne_tpu.ops.scan import RawSweep
    from loam_velodyne_tpu.parallel import replay
    from loam_velodyne_torch.tools import dryrun_dcn

    cfg = dataclasses.replace(
        replay.tiny_config(),
        lidar=LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=512),
        capacities=None)
    chunk, cap = dryrun_dcn.tiny_case(0)[3:]
    lanes = [lane for r in range(dryrun_dcn.N_PROC)
             for lane in dryrun_dcn.tiny_case(r).lanes]
    b, t = len(lanes), len(lanes[0])
    run = replay.make_batched_chunk(cfg, donate=False)
    states = replay.stack_states([engine.EngineState.create(cfg)
                                  for _ in range(b)])
    fused, counters = [], []
    for s in range(0, t, chunk):
        xyz = np.zeros((b, chunk, cap, 3), np.float32)
        mask = np.zeros((b, chunk, cap), bool)
        for i, seq in enumerate(lanes):
            for j, pts in enumerate(seq[s:s + chunk]):
                xyz[i, j, :len(pts)], mask[i, j, :len(pts)] = pts[:cap], True
        states, outs = run(states, RawSweep(jnp.asarray(xyz), jnp.asarray(mask)))
        packed = np.asarray(outs.packed)
        fused.append(packed[:, :, 15:18])
        counters.append(packed[:, :, 20:28])
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    dynamic = replay.replay_sequences(cfg, lanes, mesh, sweep_capacity=cap)
    return (np.concatenate(fused, 1), dynamic,
            np.concatenate(counters, 1))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "multihost":
        sys.path.insert(0, os.path.dirname(HERE))
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        chunked, dynamic, counters = jax_multihost_run()
        np.savez_compressed(MULTIHOST, chunked=chunked, dynamic=dynamic)
        print(f"wrote {MULTIHOST}: {chunked.shape}; the dynamic batched step "
              f"against the static chunk: {np.abs(dynamic - chunked).max():.3g}; "
              f"largest displacement {np.abs(chunked).max():.3f} m; telemetry "
              f"counters {counters.sum((0, 1)).tolist()}")
    if len(sys.argv) > 1 and sys.argv[1] == "oracle":
        sys.path[:0] = [HERE, os.path.dirname(HERE)]
        arrays = {}
        for n in ORACLE_SWEEPS:
            sweeps, gt = oracle_input(n)
            arrays[f"fused_{n}"], arrays[f"gt_{n}"] = oracle_run(sweeps), gt
        np.savez_compressed(ORACLE, **arrays)
        from loam_velodyne_torch.eval.metrics import ate_rmse
        print(f"wrote {ORACLE}: " + "; ".join(
            f"{n} sweeps, oracle-vs-gt ATE "
            f"{ate_rmse(arrays[f'fused_{n}'][:, 3:], arrays[f'gt_{n}'], align=True) * 100:.3f} cm"
            for n in ORACLE_SWEEPS) + "; the 10-sweep run against the "
            f"30-sweep run's first 10: "
            f"{np.abs(arrays['fused_10'] - arrays['fused_30'][:10]).max():.3g}")
    if len(sys.argv) > 1 and sys.argv[1] in ("regen", "golden"):
        sys.path.insert(0, os.path.dirname(HERE))
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        if sys.argv[1] == "regen":
            poses, gt, counters = jax_bench_run()
            if counters.any():
                raise SystemExit(f"telemetry not zero: {counters.sum(0)}")
        else:
            with np.load(BENCH) as ref:
                poses, gt = ref["poses"], ref["gt"]
        golden_driver = jax_golden_run()
        np.savez_compressed(BENCH, poses=poses, gt=gt,
                            golden_driver=golden_driver)
        from loam_velodyne_torch.eval.metrics import ate_rmse
        with np.load(GOLDEN) as g:
            by_sweep = np.abs(golden_driver - g["trajectory"]).max(axis=1)
        print(f"wrote {BENCH}: {poses.shape}, ATE "
              f"{ate_rmse(poses[:, 15:18], gt, align=True) * 100:.3f} cm; the "
              f"JAX driver against the golden by sweep "
              f"{[float(f'{d:.3g}') for d in by_sweep]}")
