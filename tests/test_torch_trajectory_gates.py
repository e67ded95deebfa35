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
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_trajectory.npz")
BENCH = os.path.join(HERE, "bench_trajectory_jax.npz")
GOLDEN_TOL = 2e-3           # tests/test_golden.py's tolerance
N_GOLDEN = 6
GOLDEN_GATE_SWEEPS = 3      # the sweeps before the second mapping frame
N_BENCH, CHUNK, CAP = 48, 8, 32768


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


if __name__ == "__main__":
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
