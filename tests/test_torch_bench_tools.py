"""The port's four bench tools (``loam_velodyne_torch/tools``), on the CPU:
``oracle_ab``'s variants and oracle source, ``stage_bench`` run on the
tiny dry-run case, and the arguments of ``bench_one`` and
``bench_batched_ab``, which are their JAX namesakes' (``tools/*.py``)
plus ``--device``. The tools' timings run on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.tools import (bench_batched_ab, bench_one, dryrun_dcn,
                                       oracle_ab, stage_bench)

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)


def _fields(cfg) -> dict:
    """The config's leaves as dotted paths."""
    out = {}
    for section, values in dataclasses.asdict(cfg).items():
        for key, value in (values or {}).items():
            out[f"{section}.{key}"] = value
    return out


# What tools/oracle_ab.py sets in each variant (its lines 64-78).
VARIANT_FIELDS = {
    "default": {},
    "refresh1": {"mapping.corresp_refresh_every": 1},
    "budget125": {"mapping.max_active_cubes": 125,
                  "mapping.thin_active_cubes": 125},
    "refresh1+budget125": {"mapping.corresp_refresh_every": 1,
                           "mapping.max_active_cubes": 125,
                           "mapping.thin_active_cubes": 125},
}


@pytest.mark.parametrize("name", list(VARIANT_FIELDS))
def test_oracle_ab_variant_differs_from_the_preset_in_its_fields(name):
    base = LoamConfig.preset("VLP-16")
    got = _fields(oracle_ab.variants(base)[name])
    want = _fields(base)
    diff = {k: v for k, v in got.items() if want[k] != v}
    assert diff == VARIANT_FIELDS[name]
    assert list(oracle_ab.variants(base)) == list(VARIANT_FIELDS)


def test_oracle_ab_takes_the_committed_oracle_run_then_its_cache(
        tmp_path, monkeypatch):
    """10 and 30 sweeps come from tests/oracle_trajectory.npz; another
    length from oracle_ab_<n>.npz in the temporary directory, where the
    oracle's run is cached (the oracle itself is not run here)."""
    with np.load(oracle_ab.COMMITTED) as ref:
        for n in (10, 30):
            got = oracle_ab.oracle_fused([None] * n)
            np.testing.assert_array_equal(got, ref[f"fused_{n}"])
    monkeypatch.setattr(oracle_ab.tempfile, "tempdir", str(tmp_path))
    cached = np.arange(18, dtype=np.float64).reshape(3, 6)
    np.savez(tmp_path / "oracle_ab_3.npz", fused=cached)
    np.testing.assert_array_equal(oracle_ab.oracle_fused([None] * 3), cached)


def test_stage_bench_prints_its_lines_on_the_tiny_case(monkeypatch, capsys):
    """``stage_bench --device cpu`` on two sweeps of the tiny dry-run
    case (its config and sweeps in place of the preset's), one timed
    call a stage: the header and the JAX tool's six lines."""
    case = dryrun_dcn.tiny_case(0)
    monkeypatch.setattr(stage_bench.LoamConfig, "preset",
                        staticmethod(lambda name: case.cfg))
    monkeypatch.setattr(synthetic, "bench_sweeps",
                        lambda n, lidar: (case.lanes[0][:n], case.gts[0][:n]))
    monkeypatch.setattr(stage_bench, "N_SWEEPS", 2)
    monkeypatch.setattr(stage_bench, "REPS", 1)
    times = stage_bench.main(["tiny", "--sized", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    labels = ["ingest+features", "step (mapping off)", "step (mapping on)",
              "-> odometry (off - feat)", "-> mapping increment",
              "-> amortized/sweep @io_ratio"]
    assert lines[0].startswith("tiny: input N=") and len(lines) == 7
    for line, label in zip(lines[1:], labels):
        assert line.startswith(label) and line.endswith(" ms")
        float(line[34:-3])
    assert all(t > 0 for t in times.values())


@pytest.mark.parametrize("argv, want", [
    ([], ("HDL-64E", 48, False, [])),
    (["HDL-32", "16", "--datasheet-cap", "--set", "odometry.max_iterations=5",
      "--set", "mapping.max_iterations=3"],
     ("HDL-32", 16, True, ["odometry.max_iterations=5",
                           "mapping.max_iterations=3"])),
])
def test_bench_one_takes_its_jax_namesakes_arguments(argv, want):
    args = bench_one.parse_args(argv)
    assert (args.preset, args.n_sweeps, args.datasheet_cap, args.set) == want
    assert args.device == "cuda"


@pytest.mark.parametrize("argv, want", [
    ([], ("VLP-16", 48, 8, [])),
    (["HDL-64E", "24", "4", "--set", "mapping.surf_cube_capacity=1024"],
     ("HDL-64E", 24, 4, ["mapping.surf_cube_capacity=1024"])),
])
def test_bench_batched_ab_takes_its_jax_namesakes_arguments(argv, want):
    args = bench_batched_ab.parse_args(argv + ["--device", "cpu"])
    assert (args.preset, args.n_sweeps, args.batch, args.set) == want
    assert args.device == "cpu"


@pytest.mark.parametrize("tool", [bench_one, bench_batched_ab])
@pytest.mark.parametrize("n_sweeps", ["20", "19", "8"])
def test_bench_tools_refuse_the_sweep_counts_the_bench_refuses(tool, n_sweeps,
                                                               capsys):
    """The tools time a rate as the bench does: whole chunks after the
    warm-up chunk, by the bench's own check."""
    with pytest.raises(SystemExit) as e:
        tool.parse_args(["VLP-16", n_sweeps, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "multiple of 8 and at least 16" in err and f"got {n_sweeps}" in err


@pytest.mark.parametrize("tool", [bench_one, bench_batched_ab, stage_bench,
                                  oracle_ab])
def test_tool_runs_on_the_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["VLP-16"] if tool is not oracle_ab else [])
