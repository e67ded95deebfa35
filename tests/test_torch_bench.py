"""Port parity, the benchmark: ``loam_velodyne_torch.bench`` against the
repository's ``bench.py`` (the JAX package's bench), on the CPU.

The reference is ``bench.py``'s own functions, run once on the tiny dry
run's first lane (``tools/dryrun_dcn.py::tiny_case(0)``: 4 rings of 512
points, the narrow corridor, 8 sweeps on the 1/128 m grid, chunks of 4,
sweeps padded to 2,048 rows) and kept in ``tests/bench_jax_tiny.npz``,
written by

    python tests/test_torch_bench.py regen

(JAX on the CPU, about a minute): ``bench_single_stream``'s aligned ATE
and telemetry, and ``bench_live_latency``'s cadence counters. The port's
functions must give the ATE within ATE_TOL, the five telemetry sums and
the two counters exactly. Rates and latencies are not compared.

Every line function of the port is driven at the tiny shapes (4 sweeps,
chunks of 2, 2 lanes); each line must carry the metric, unit and key
set, nested keys included, of its line in the committed
``BENCH_LATEST.json`` (read, never written). ``main``'s arguments, its
artifact and the command's ``bench`` are checked without running the
bench at preset width.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":           # python tests/test_torch_bench.py regen
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loam_velodyne_torch import bench, cli  # noqa: E402
from loam_velodyne_torch.config import LoamConfig, apply_overrides  # noqa: E402
from loam_velodyne_torch.tools import dryrun_dcn  # noqa: E402

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFERENCE = os.path.join(HERE, "bench_jax_tiny.npz")
JAX_LINES = os.path.join(ROOT, "BENCH_LATEST.json")
TEL_KEYS = ("ingest_dropped", "feature_dropped", "cube_dropped",
            "stack_dropped", "active_cube_deficit")
# The 8-sweep tiny case's poses part from the JAX package's by float32
# rounding in the GN solves (8.6e-7 on the dry run's lanes,
# tests/test_torch_multihost.py); the ATE by no more.
ATE_TOL = 1e-5
LINE_SWEEPS, LINE_CHUNK, LINE_BATCH = 4, 2, 2


def _case():
    case = dryrun_dcn.tiny_case(0)
    return case.cfg, case.lanes[0], case.gts[0], case.chunk, case.cap


def _reference() -> dict:
    with np.load(REFERENCE) as z:
        return {k: z[k] for k in z.files}


def _jax_lines() -> dict:
    with open(JAX_LINES) as f:
        return {line["metric"]: line for line in json.load(f)["lines"]}


def test_reference_is_the_tiny_case_through_the_jax_bench():
    ref = _reference()
    _, sweeps, gt, _, _ = _case()
    np.testing.assert_array_equal(ref["gt"], gt)
    assert len(sweeps) == 8
    assert np.isfinite(ref["ate"]) and 0 < ref["ate"] < 1
    assert ref["telemetry"].shape == (len(TEL_KEYS),)
    # The warm-up's build and the cadence's.
    assert ref["surround_dispatches"] >= 1


def test_single_stream_matches_the_jax_bench():
    ref = _reference()
    cfg, sweeps, gt, chunk, cap = _case()
    rate, ate, tel = bench.bench_single_stream(cfg, sweeps, gt, chunk, cap,
                                               device="cpu")
    assert rate > 0
    assert abs(ate - float(ref["ate"])) <= ATE_TOL, (ate, float(ref["ate"]))
    assert list(tel) == list(TEL_KEYS)
    assert [tel[k] for k in TEL_KEYS] == ref["telemetry"].tolist()


def test_live_latency_matches_the_jax_bench():
    ref = _reference()
    cfg, sweeps, _, _, cap = _case()
    p50, p_max, attribution = bench.bench_live_latency(cfg, sweeps, cap=cap,
                                                       device="cpu")
    want = _jax_lines()["vlp16_full_pipeline_throughput"]
    assert set(attribution) == set(want["extra"]["live_max_attribution"])
    assert 0 < p50 <= p_max
    assert 0 <= attribution["max_sweep_index"] < len(sweeps) - 1
    assert attribution["surround_dispatches"] == int(ref["surround_dispatches"])
    assert attribution["archive_compactions"] == int(ref["archive_compactions"])


def _line(metric: str) -> dict:
    cfg, sweeps, gt, _, cap = _case()
    sweeps, gt = sweeps[:LINE_SWEEPS], gt[:LINE_SWEEPS]
    if metric == "vlp16_full_pipeline_throughput":
        return bench.headline_line(cfg, sweeps, gt, LINE_BATCH, LINE_CHUNK, cap,
                                   "cpu")
    if metric == "vlp16_odometry_only":
        return bench.odometry_only_line(cfg, sweeps, gt, LINE_CHUNK, cap, "cpu")
    name = {"hdl32_full_pipeline": "HDL-32", "hdl64e_full_pipeline": "HDL-64E"}
    return bench.preset_line(name[metric], cfg, sweeps, gt, LINE_CHUNK, cap,
                             "cpu")


@pytest.mark.parametrize("metric", ["vlp16_full_pipeline_throughput",
                                    "vlp16_odometry_only",
                                    "hdl32_full_pipeline",
                                    "hdl64e_full_pipeline"])
def test_line_has_the_jax_lines_keys(metric):
    want = _jax_lines()[metric]
    line = _line(metric)
    assert line["metric"] == metric and line["unit"] == want["unit"]
    assert bench.key_paths(line) == bench.key_paths(want)
    assert line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10, abs=1e-5)
    extra = line["extra"]
    assert 0 <= extra["ate_aligned_m"] < 1
    if "telemetry" in extra:
        assert list(extra["telemetry"]) == list(TEL_KEYS)
    if metric == "vlp16_full_pipeline_throughput":
        assert (extra["batch"], extra["chunk"], extra["n_sweeps"],
                extra["device"]) == (LINE_BATCH, LINE_CHUNK,
                                     LINE_SWEEPS - LINE_CHUNK, "cpu")
        assert line["value"] == extra["batched_distinct_sweeps_per_sec"]
    json.dumps(line)


def test_distinct_lanes_are_the_jax_benchs():
    """Lane b's trajectory: bench.py's yaw rate and sway frequency."""
    from loam_velodyne_torch.io import synthetic
    lanes = bench.distinct_lanes(2, 4)
    for b, lane in enumerate(lanes):
        traj = synthetic.turning_trajectory(
            speed=1.0, yaw_rate=0.05 * (1 + 0.4 * b / 4) * (-1) ** (b + 1),
            sway_freq=0.15 + 0.02 * b)
        want, _, _ = synthetic.generate_sequence(2, n_azimuth=900, speed=1.0,
                                                 noise_std=0.005, traj=traj)
        for got, w in zip(lane, want):
            np.testing.assert_array_equal(got, w)
    assert not np.array_equal(lanes[0][1], lanes[1][1])


@pytest.mark.parametrize("n_sweeps", ["30", "8", "12", "0"])
def test_main_refuses_sweeps_that_leave_no_timed_chunk(n_sweeps, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main([n_sweeps, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "multiple of 8 and at least 16" in err and f"got {n_sweeps}" in err


def test_command_lists_bench_with_48_sweeps(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--help"])
    assert e.value.code == 0
    out = " ".join(capsys.readouterr().out.split())
    assert "--sweeps" in out and "(default 48)" in out and "--device" in out


def test_default_device_is_the_card():
    args = bench.parse_args([])
    assert (args.n_sweeps, args.batch, args.device, args.headline_only) == (
        48, 8, "cuda", False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["16"])
    cfg, sweeps, gt, chunk, cap = _case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_single_stream(cfg, sweeps, gt, chunk, cap)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["bench"])


def test_main_emits_the_four_lines_and_writes_only_its_artifact(
        tmp_path, monkeypatch):
    """main's wiring, with the line functions and the simulator stubbed:
    the VLP-16 lines get the overridden preset sized to its stream, the
    HDL lines their presets; the full run writes {"ts", "lines"} to
    --out and nothing else; --headline-only emits one line and writes
    nothing."""
    calls = []

    def sweeps_of(n, lidar):
        pts = np.zeros((100 * lidar.n_rings, 3), np.float32)
        return [pts] * n, np.zeros((n, 3))

    def stub(metric):
        def line(*args):
            calls.append((metric, args))
            return {"metric": metric}
        return line

    monkeypatch.setattr(bench.synthetic, "bench_sweeps", sweeps_of)
    monkeypatch.setattr(bench, "headline_line", stub("headline"))
    monkeypatch.setattr(bench, "odometry_only_line", stub("odometry"))
    monkeypatch.setattr(bench, "preset_line",
                        lambda name, *a: stub(name)(*a))
    before = os.path.getmtime(JAX_LINES)
    out = tmp_path / "latest.json"
    lines = bench.main(["16", "2", "--device", "cpu", "--out", str(out),
                        "--set", "odometry.max_iterations=7"])
    assert [line["metric"] for line in lines] == [
        "headline", "odometry", "HDL-32", "HDL-64E"]
    (_, head), (_, odo), (_, hdl32), (_, hdl64) = calls
    cfg, sweeps, gt, batch, chunk, cap, device = head
    assert (len(sweeps), batch, chunk, cap, str(device)) == (16, 2, 8, 1664,
                                                             "cpu")
    want = apply_overrides(LoamConfig.preset("VLP-16"),
                           ["odometry.max_iterations=7"])
    assert cfg == want.sized_for_stream(1664) and cfg.odometry.max_iterations == 7
    assert odo[0] is cfg
    assert hdl32[0].lidar.n_rings == 32 and hdl64[0].lidar.n_rings == 64
    assert hdl64[0].odometry.max_iterations == LoamConfig.preset(
        "HDL-64E").odometry.max_iterations
    with open(out) as f:
        art = json.load(f)
    assert set(art) == {"ts", "lines"} and art["lines"] == lines
    assert os.path.getmtime(JAX_LINES) == before

    calls.clear()
    out2 = tmp_path / "headline.json"
    lines = bench.main(["16", "--headline-only", "--device", "cpu",
                        "--out", str(out2)])
    assert [line["metric"] for line in lines] == ["headline"]
    assert not out2.exists()


def jax_tiny_run() -> dict:
    """bench.py's single stream and live latency on the tiny case, JAX on
    the CPU."""
    import dataclasses

    import jax
    import bench as jax_bench
    # bench.py turns on the persistent compile cache, which is for the
    # TPU only (tests/conftest.py).
    jax.config.update("jax_enable_compilation_cache", False)
    from loam_velodyne_tpu.config import LidarConfig
    from loam_velodyne_tpu.parallel.replay import tiny_config

    cfg = dataclasses.replace(
        tiny_config(),
        lidar=LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=512),
        capacities=None)
    _, sweeps, gt, chunk, cap = _case()
    _, ate, tel = jax_bench.bench_single_stream(cfg, sweeps, gt, chunk, cap=cap)
    _, _, attribution = jax_bench.bench_live_latency(cfg, sweeps, cap=cap)
    return {"gt": gt, "ate": np.float64(ate),
            "telemetry": np.asarray([tel[k] for k in TEL_KEYS], np.int64),
            "surround_dispatches": attribution["surround_dispatches"],
            "archive_compactions": attribution["archive_compactions"]}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        arrays = jax_tiny_run()
        np.savez_compressed(REFERENCE, **arrays)
        print(f"wrote {REFERENCE}: " + ", ".join(
            f"{k} {v.tolist() if hasattr(v, 'tolist') else v}"
            for k, v in arrays.items() if k != "gt"))
