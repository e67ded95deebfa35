"""loam_velodyne_torch/tools/device_split.py, the tool that locates where
the card and the CPU part, rehearsed on the CPU (``--device cpu``): held
against itself, every traced call's CPU replay agrees exactly, and the
trace reaches from the stages down to the fits. The tool steps
chip_smoke's own live IMU input: chip_smoke builds its IMU drivers with
the tool's ``imu_driver`` and the same stream length."""

import json

import chip_smoke
from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.tools import device_split


def test_device_split_rehearsal_on_the_cpu(tmp_path):
    out = tmp_path / "split.json"
    assert device_split.main(["--device", "cpu", "--before", "3",
                              "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["device"] == "cpu" and rep["calls"] > 0
    assert rep["pose_dev_from_start"] == [0.0, 0.0, 0.0, 0.0]
    assert rep["split_sweep_from_common_state_max_dev"] == 0.0
    calls = [e["call"] for e in rep["trace"]]
    assert {"scan.ingest_sweep", "features.ring_curvature",
            "features.greedy_pick_rows", "odometry.solve_gn", "mapping.step",
            "mapping.tiled_windowed_knn", "fit.plane_fit"} <= set(calls)
    for e in rep["trace"]:
        assert e["replay"]["float"] == 0.0 and e["replay"]["int"] == 0, e["call"]
    fits = [e["fit"] for e in rep["trace"] if "fit" in e]
    assert fits and all(f["rows_differing"] == 0 for f in fits)


def test_device_split_steps_the_smoke_imu_input():
    """The tool's IMU driver holds what chip_smoke's live run holds: a
    stream of chip_smoke.LIVE_SWEEPS sweeps, cut to the tracker's
    history."""
    cfg = LoamConfig.preset("VLP-16")
    assert device_split.STREAM_SWEEPS == chip_smoke.LIVE_SWEEPS
    smoke = chip_smoke._imu_driver(cfg, "cpu", chip_smoke.SWEEP_CAP).imu_tracker
    tool = device_split.imu_driver(cfg, "cpu").imu_tracker
    assert smoke.stamps == tool.stamps
    assert len(tool.stamps) == cfg.registration.imu_history_size
    assert all((a == b).all() for a, b in zip(smoke.pos, tool.pos))
