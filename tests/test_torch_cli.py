"""Port parity, the entry points: loam_velodyne_torch.cli (the loam-torch
command: run, validate, profile, info), LoamDriver.run_bag and
io.live.LiveFeeder, against the JAX package's cli, run_bag and live
feeder, on the CPU (``--device cpu``, ``device="cpu"``).

Both commands run the same configuration: test_torch_engine's
``slice_config()``, given to each as ``--set`` overrides of the VLP-16
preset. The JAX drivers that the tests create share one compiled step
(``_SharedJDriver``), so the module compiles the JAX engine once.

Tolerances and why:
- run_bag poses against the JAX run_bag on one bag of 6 quantized
  sweeps (1/256 m grid): 1e-4 without an IMU (observed maximum
  deviation: 7.5e-8; ingest and features are bit-equal, the GN solves
  round differently) and 1e-3 with a rocking IMU in the bag (observed
  maximum deviation: 4.4e-5; the deskew's rotations round differently,
  so near-equal curvatures can order differently, ROADMAP queue 3).
  The mapping flags: exact.
- The report of each command: the same keys as the JAX command's, the
  same sweep count.
- validate: a golden the JAX command recorded gates the port's run of
  the same bag within 1e-4 (observed: 0.0 m in the report's 4
  decimals); the port's own replay gates its golden at <= 1e-4
  (observed: 0, the CPU replay is deterministic). The slow case at the
  full VLP-16 preset on the unquantized wire pcap: the JAX golden gates
  the port within 0.01 m, a little over twice the observed 0.004 m (the
  JAX golden lies ~1.8 cm from the simulator's truth, so the command's
  default 5 cm would pass even the true trajectory).
- The port's resume on a bag reproduces the uninterrupted run exactly.
"""

import argparse
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from loam_velodyne_tpu import cli as jcli
from loam_velodyne_tpu.config import LoamConfig
from loam_velodyne_tpu.io import driver as jdriver_mod
from loam_velodyne_tpu.io.imu import ImuTracker as JTracker
from loam_velodyne_tpu.io.rosbag import BagWriter
from loam_velodyne_torch import cli as tcli
from loam_velodyne_torch.eval.metrics import ate_rmse
from loam_velodyne_torch.io import kitti as tkitti
from loam_velodyne_torch.io import synthetic as tsyn
from loam_velodyne_torch.io.driver import LoamDriver as TDriver
from loam_velodyne_torch.io.live import LiveFeeder
from loam_velodyne_torch.io.pcd import read_pcd
from loam_velodyne_torch.tools import make_validation_pcap as tmk
from test_torch_engine import _port, _sweeps, slice_config

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

N = 6
T0 = 1000.0
_COMPILED = {}


class _SharedJDriver(jdriver_mod.LoamDriver):
    """The JAX driver with one compiled step for all instances of a
    configuration: the IMU step. Without an IMU it gets an empty window,
    which leaves the points, the odometry and the mapping pose exactly
    as the step without a window does (the JAX package selects them with
    ``where`` on the window's count)."""

    def __init__(self, cfg=None, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        step_imu = _COMPILED.setdefault(repr(self.cfg), self._step_imu)
        empty = JTracker().window_for_sweep(0.0)
        self._step_imu = step_imu
        self._step = lambda state, raw: step_imu(state, raw, empty)


@pytest.fixture
def jax_shared(monkeypatch):
    monkeypatch.setattr(jdriver_mod, "LoamDriver", _SharedJDriver)


def _set_args(cfg) -> list:
    """``--set`` overrides that turn the VLP-16 preset into ``cfg``; the
    search neighbourhood and the recenter margin shrink before the grid,
    so that every step is a valid configuration."""
    base = LoamConfig.preset("VLP-16")
    first = ("neighborhood", "recenter_margin")
    out = []
    for sec in ("lidar", "registration", "odometry", "mapping", "capacities"):
        a, b = getattr(cfg, sec), getattr(base, sec)
        for f in sorted(dataclasses.fields(a), key=lambda f: f.name not in first):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if va != vb:
                raw = va if isinstance(va, str) else json.dumps(va)
                out += ["--set", f"{sec}.{f.name}={raw}"]
    return out


def _quat(roll, pitch, yaw):
    """Fixed-axis roll/pitch/yaw -> quaternion (x, y, z, w), the inverse
    of io/imu.rpy_from_quaternion."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return (sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy)


def _raw_acc(rpy, acc_swapped, g=9.81):
    """The sensor-frame acceleration that ImuTracker.push_raw turns into
    ``acc_swapped`` (gravity added back, axes unswapped)."""
    r, p, _ = rpy
    return (acc_swapped[2] - np.sin(p) * g,
            acc_swapped[0] + np.sin(r) * np.cos(p) * g,
            acc_swapped[1] + np.cos(r) * np.cos(p) * g)


def write_bag(path, sweeps, imu: bool):
    """Sweeps as /velodyne_points at 10 Hz from T0; with ``imu`` the
    rocking stream of io/synthetic.imu_stream as raw /imu/data messages
    at 100 Hz, in time order."""
    msgs = [(T0 + 0.1 * k, "cloud", pts) for k, pts in enumerate(sweeps)]
    if imu:
        msgs += [(T0 + t, "imu", (rpy, acc))
                 for t, rpy, acc in tsyn.imu_stream(len(sweeps))]
    msgs.sort(key=lambda m: (m[0], m[1] == "cloud"))
    with BagWriter(str(path)) as w:
        for stamp, kind, payload in msgs:
            if kind == "cloud":
                w.write_cloud("/velodyne_points", stamp, payload)
            else:
                rpy, acc = payload
                w.write_imu("/imu/data", stamp, _quat(*rpy), _raw_acc(rpy, acc))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = slice_config()
    xyz, mask, gt = _sweeps(cfg, N)
    sweeps = [xyz[i][mask[i]] for i in range(N)]
    d = tmp_path_factory.mktemp("bags")
    bags = {imu: d / f"seq_imu{int(imu)}.bag" for imu in (False, True)}
    for imu, path in bags.items():
        write_bag(path, sweeps, imu)
    return {"cfg": cfg, "sweeps": sweeps, "gt": gt, "bags": bags,
            "set": _set_args(cfg)}


@pytest.fixture(scope="module")
def bag_runs(data):
    """The JAX and the port run_bag on each bag."""
    out = {}
    for imu, path in data["bags"].items():
        jd = _SharedJDriver(data["cfg"], system_delay=0)
        jd.run_bag(str(path))
        td = TDriver(_port(data["cfg"]), device="cpu", system_delay=0)
        td.run_bag(str(path))
        out[imu] = (jd, td)
    return out


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_set_args_build_the_configuration(data):
    ns = argparse.Namespace(lidar="VLP-16", set=data["set"][1::2])
    assert tcli._build_config(ns) == _port(data["cfg"])
    assert jcli._build_config(ns) == data["cfg"]


@pytest.mark.parametrize("mod", [jcli, tcli], ids=["jax", "port"])
@pytest.mark.parametrize("item,message", [
    ("odometry.nonexistent=1", "unknown config field"),
    ("odometry.max_iterations", "expects key=value")])
def test_bad_override_and_missing_value(mod, item, message):
    with pytest.raises(SystemExit, match=message):
        mod.main(["run", "--set", item, "--sweeps", "1"]
                 + (["--device", "cpu"] if mod is tcli else []))


def test_info(capsys):
    tcli.main(["info"])
    out = json.loads(capsys.readouterr().out)
    assert sorted(out["lidar_presets"]) == ["HDL-32", "HDL-64E", "VLP-16"]
    assert out["backend"] == "cpu" and out["devices"] == []
    assert out["torch"] and "version" in out


def test_run_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["run", "--sweeps", "1"])


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_run_bag_matches_jax(bag_runs, imu):
    jd, td = bag_runs[imu]
    tol = 1e-3 if imu else 1e-4
    assert len(td.trajectory) == len(jd.trajectory) == N
    for name in ("trajectory", "odom_trajectory", "mapped_trajectory"):
        np.testing.assert_allclose(np.stack(getattr(td, name)),
                                   np.stack(getattr(jd, name)), rtol=0,
                                   atol=tol, err_msg=name)
    assert td.mapping_ran == [k % 2 == 1 for k in range(N)]
    if imu:        # the IMU reached the poses
        assert np.abs(np.stack(td.trajectory)
                      - np.stack(bag_runs[False][1].trajectory)).max() > tol


def test_run_bag_resume_skips_processed(data, tmp_path):
    """Resume against the same bag: run_bag after resume() skips the
    clouds the checkpoint already consumed (tests/test_bag_pipeline.py),
    and reproduces the uninterrupted run exactly."""
    cfg = _port(data["cfg"])
    full = data["bags"][True]
    first3 = tmp_path / "first3.bag"
    write_bag(first3, data["sweeps"][:3], imu=True)
    ref = TDriver(cfg, device="cpu", system_delay=0)
    ref.run_bag(str(full))
    ckpt = str(tmp_path / "ck.npz")
    drv = TDriver(cfg, device="cpu", system_delay=0, checkpoint_path=ckpt,
                  checkpoint_every=1)
    drv.run_bag(str(first3))
    drv2 = TDriver(cfg, device="cpu", system_delay=0, checkpoint_path=ckpt)
    assert drv2.resume() and drv2.resumed_sweeps == 3
    drv2.run_bag(str(full))
    assert len(drv2.trajectory) == N - 3
    np.testing.assert_array_equal(np.stack(drv2.trajectory),
                                  np.stack(ref.trajectory[3:]))


@pytest.mark.parametrize("source", ["synthetic", "bag"])
def test_run_report_matches_jax(data, tmp_path, capsys, jax_shared, source):
    """Both commands on the same input with every export: the same
    report keys, the same sweep count, readable exports."""
    reports = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        out = tmp_path / name
        out.mkdir()
        argv = ["run", "--source", source, "--sweeps", "3", "--azimuth", "600",
                "--out-traj", str(out / "t.tum"), "--out-map",
                str(out / "m.pcd"), "--out-full-map", str(out / "f.pcd"),
                "--out-plot", str(out / "p.png"), "--checkpoint",
                str(out / "c.npz"), *data["set"]]
        if source == "bag":
            argv += ["--path", str(data["bags"][False])]
        if mod is tcli:
            argv += ["--device", "cpu"]
        mod.main(argv)
        reports[name] = _report(capsys)
        for f in ("t.tum", "m.pcd", "f.pcd", "p.png", "c.npz"):
            assert (out / f).stat().st_size > 0, f
        assert len(read_pcd(str(out / "f.pcd"))[0]) > 100
    j, t = reports["jax"], reports["port"]
    assert set(t) == set(j)
    assert t["sweeps"] == j["sweeps"] == (3 if source == "synthetic" else N)
    if source == "synthetic":
        assert np.isfinite(t["ate_m"]) and np.isfinite(t["rpe_m"])
    else:
        tj = np.loadtxt(tmp_path / "jax" / "t.tum")
        tt = np.loadtxt(tmp_path / "port" / "t.tum")
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-4)


def test_run_kitti_and_pcap_sources(data, tmp_path, capsys):
    """The port's command on a KITTI directory with a poses file (ATE and
    RPE in the report) and on a wire-format pcap."""
    seq = tmp_path / "velodyne"
    seq.mkdir()
    for k, pts in enumerate(data["sweeps"][:3]):
        tkitti.write_velodyne_bin(str(seq / f"{k:06d}.bin"), pts)
    rows = np.zeros((3, 12))
    rows[:, 0] = rows[:, 5] = rows[:, 10] = 1.0
    rows[:, [3, 7, 11]] = -data["gt"][:3] * [1, 1, -1]
    poses = tmp_path / "poses.txt"
    np.savetxt(poses, rows)
    tcli.main(["run", "--source", "kitti", "--path", str(seq), "--gt-poses",
               str(poses), "--device", "cpu", *data["set"]])
    rep = _report(capsys)
    assert rep["sweeps"] == 3 and rep["ate_m"] < 0.5 and "rpe_m" in rep

    cap = tmp_path / "wire.pcap"
    tmk.write_validation_pcap(str(cap), 2, n_az=600)
    tcli.main(["run", "--source", "pcap", "--path", str(cap), "--device", "cpu",
               *data["set"]])
    assert _report(capsys)["sweeps"] == 2


def test_validate_records_gates_and_fails_on_drift(data, tmp_path, capsys,
                                                   jax_shared):
    bag = str(data["bags"][False])
    golden = str(tmp_path / "jax.golden.npz")
    # A golden the JAX command records gates the port's replay.
    jcli.main(["validate", "--path", bag, "--golden", golden, *data["set"]])
    assert _report(capsys)["recorded"]
    args = ["validate", "--path", bag, "--device", "cpu", *data["set"]]
    tcli.main(args + ["--golden", golden])
    rep = _report(capsys)
    assert rep["ok"] and rep["ate_vs_golden_m"] <= 1e-4
    assert rep["source"] == "bag" and rep["sweeps"] == N

    # The port records its own golden, then gates against it.
    own = str(tmp_path / "port.golden.npz")
    tcli.main(args + ["--golden", own])
    rep = _report(capsys)
    assert rep["recorded"] and rep["ok"] and os.path.exists(own)
    tcli.main(args + ["--golden", own])
    rep = _report(capsys)
    assert rep["ok"] and rep["ate_vs_golden_m"] <= 1e-4

    # A drifted trajectory fails the gate loudly.
    with np.load(own) as g:
        pos, traj = g["positions"], g["trajectory"]
    np.savez_compressed(own, positions=pos + 0.5, trajectory=traj)
    with pytest.raises(SystemExit, match="drifted"):
        tcli.main(args + ["--golden", own])


def test_validate_no_data_exits_with_mount_instructions(tmp_path, monkeypatch):
    for var in ("LOAM_TEST_BAG", "LOAM_PCAP", "LOAM_KITTI_SEQ"):
        monkeypatch.delenv(var, raising=False)
    fetched = []
    monkeypatch.setattr(tcli, "_fetch_reference_bag",
                        lambda d: fetched.append(d))
    with pytest.raises(SystemExit, match="LOAM_TEST_BAG"):
        tcli.main(["validate", "--device", "cpu", "--cache-dir",
                   str(tmp_path / "nocache")])
    assert fetched == [str(tmp_path / "nocache")]


def test_profile_writes_a_trace(data, tmp_path, capsys):
    out = tmp_path / "trace"
    tcli.main(["profile", "--sweeps", "1", "--warmup", "1", "--azimuth", "600",
               "--out", str(out), "--device", "cpu", *data["set"]])
    rep = _report(capsys)
    assert rep["sweeps"] == 1 and rep["trace_dir"] == str(out)
    with open(out / "trace.json") as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------------------
# The live feeder (tests/test_live.py's cases)
# ---------------------------------------------------------------------------

class SlowDriver:
    def __init__(self, delay=0.0):
        self.delay = delay
        self.seen = []

    def process_sweep(self, pts, stamp=None):
        if self.delay:
            time.sleep(self.delay)
        self.seen.append(stamp)


def test_live_fifo_when_keeping_up():
    drv = SlowDriver()
    f = LiveFeeder(drv, queue_depth=2)
    for k in range(3):
        f.push(np.zeros((1, 3)), stamp=float(k))
        assert f.spin_once()
    assert drv.seen == [0.0, 1.0, 2.0]
    assert f.stats["dropped"] == 0


def test_live_latest_wins_shedding():
    drv = SlowDriver()
    f = LiveFeeder(drv, queue_depth=2)
    for k in range(5):
        f.push(np.zeros((1, 3)), stamp=float(k))
    while f.spin_once():
        pass
    assert drv.seen == [3.0, 4.0]
    assert f.stats == {"pushed": 5, "processed": 2, "dropped": 3, "queued": 0}


def test_live_threaded_producer_consumer():
    drv = SlowDriver(delay=0.005)
    f = LiveFeeder(drv, queue_depth=2)

    def produce():
        for k in range(40):
            f.push(np.zeros((1, 3)), stamp=float(k))
            time.sleep(0.001)
        time.sleep(0.1)
        f.stop()

    t = threading.Thread(target=produce)
    t.start()
    f.spin(timeout=5.0)
    t.join(timeout=5.0)
    assert not t.is_alive()
    s = f.stats
    assert s["processed"] + s["dropped"] + s["queued"] == s["pushed"] == 40
    assert s["dropped"] > 0
    assert drv.seen == sorted(drv.seen)


def test_live_feeder_over_the_port_driver(data):
    """A sensor thread pushing sweeps at 10 Hz into a feeder over the
    port's driver: the counts add up, and once the feeder has drained
    what was left queued at the stop (how much is shed depends on the
    host's speed), the newest sweeps were processed, each with a finite
    pose."""
    drv = TDriver(_port(data["cfg"]), device="cpu", system_delay=0)
    f = LiveFeeder(drv, queue_depth=2)

    def produce():
        for k, pts in enumerate(data["sweeps"]):
            f.push(pts, stamp=0.1 * k)
            time.sleep(0.1)
        f.stop()

    t = threading.Thread(target=produce)
    t.start()
    f.spin(timeout=30.0)
    t.join(timeout=30.0)
    assert not t.is_alive()
    s = f.stats
    assert s["pushed"] == N == s["processed"] + s["dropped"] + s["queued"]
    while f.spin_once():
        pass
    s = f.stats
    assert s["pushed"] == s["processed"] + s["dropped"] and s["queued"] == 0
    assert s["processed"] >= 2 and len(drv.trajectory) == s["processed"]
    assert np.isfinite(np.stack(drv.trajectory)).all()


@pytest.mark.slow
def test_port_validate_gates_a_jax_golden_on_the_wire_pcap(tmp_path, capsys):
    """At the full VLP-16 preset: the JAX command records a golden on the
    6-sweep wire-format pcap (tests/test_validate.py's capture), and the
    port's validate of the same capture gates against it within 0.01 m
    (observed: 0.004 m). The sweeps are not quantized, so the two
    packages' trajectories part by the features' tie effect (ROADMAP
    queue 3)."""
    path = str(tmp_path / "wire_vlp16.pcap")
    gt = tmk.write_validation_pcap(path, 6)
    golden = str(tmp_path / "jax.golden.npz")
    jcli.main(["validate", "--path", path, "--golden", golden])
    assert _report(capsys)["recorded"]
    tcli.main(["validate", "--path", path, "--golden", golden,
               "--ate-tol", "0.01", "--device", "cpu"])
    rep = _report(capsys)
    with capsys.disabled():
        print(f"\nport against the JAX golden on the wire pcap: "
              f"{rep['ate_vs_golden_m']} m")
    assert rep["ok"] and rep["sweeps"] == 6 and rep["ate_vs_golden_m"] <= 0.01
    with np.load(golden) as g:
        assert ate_rmse(g["positions"], gt, align=True) < 0.05
