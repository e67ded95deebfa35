"""Command-line entry points of the PyTorch port: the ``loam-torch`` command.

Counterpart of ``loam_velodyne_tpu/cli.py`` (the ``loam-tpu`` command),
flag for flag, plus ``--device`` (default ``cuda``): every command that
steps the engine runs on the card unless asked for the CPU, and fails
without a card.

    python -m loam_velodyne_torch.cli run --source synthetic --sweeps 50
    python -m loam_velodyne_torch.cli run --source bag --path data.bag
    python -m loam_velodyne_torch.cli run --source pcap --path capture.pcap
    python -m loam_velodyne_torch.cli run --source kitti --path seq/velodyne \\
        --gt-poses seq.txt --lidar HDL-64E
    python -m loam_velodyne_torch.cli validate --path capture.pcap
    python -m loam_velodyne_torch.cli profile --sweeps 4
    python -m loam_velodyne_torch.cli info
    python -m loam_velodyne_torch.cli run --device cpu ...

Parameter overrides use dotted dataclass paths, mirroring the reference
launch-file params (launch/loam_velodyne.launch:7-8):

    --set registration.scan_period=0.1 --set odometry.max_iterations=25

The JAX command's ``bench`` is not ported yet: it waits for a benchmark
of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _apply_overrides(cfg, overrides):
    """Apply dotted-path overrides to the frozen config tree."""
    for item in overrides or []:
        path, _, raw = item.partition("=")
        if not _:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        keys = path.split(".")
        targets = [cfg]
        for k in keys[:-1]:
            targets.append(getattr(targets[-1], k))
        field_types = {f.name: f.type for f in dataclasses.fields(targets[-1])}
        if keys[-1] not in field_types:
            raise SystemExit(f"unknown config field {path!r}")
        old = getattr(targets[-1], keys[-1])
        value = type(old)(json.loads(raw)) if not isinstance(old, str) else raw
        obj = dataclasses.replace(targets[-1], **{keys[-1]: value})
        for parent, k in zip(reversed(targets[:-1]), reversed(keys[:-1])):
            obj = dataclasses.replace(parent, **{k: obj})
        cfg = obj
    return cfg


def _build_config(args):
    from loam_velodyne_torch.config import LoamConfig
    cfg = LoamConfig.preset(args.lidar)
    cfg = _apply_overrides(cfg, args.set)
    return cfg


def _driver(args, cfg):
    """The driver on ``args.device``; a card that is asked for and
    missing ends the command."""
    from loam_velodyne_torch.io.driver import LoamDriver
    from loam_velodyne_torch.models.engine import require_device
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    return LoamDriver(cfg, device, system_delay=args.system_delay)


def _load_sweeps(args, cfg):
    if args.source == "synthetic":
        from loam_velodyne_torch.io import synthetic
        sweeps, gt, times = synthetic.generate_sequence(
            args.sweeps, lidar=cfg.lidar, n_azimuth=args.azimuth,
            speed=args.speed)
        return sweeps, gt, times
    if args.source == "bag":
        from loam_velodyne_torch.io.rosbag import read_bag_sweeps
        sweeps, times = read_bag_sweeps(args.path, topic=args.topic)
        return sweeps, None, times
    if args.source == "pcap":
        from loam_velodyne_torch.io.pcap import (load_calibration,
                                                 read_pcap_sweeps)
        calib = (load_calibration(args.calibration)
                 if getattr(args, "calibration", None) else None)
        sweeps, times = read_pcap_sweeps(args.path, cfg.lidar,
                                         calibration=calib)
        return sweeps, None, times
    if args.source == "kitti":
        # KITTI odometry sequence dir of %06d.bin scans (+ optional
        # ground-truth poses file -> ATE/RPE in the report).
        from loam_velodyne_torch.io import kitti
        sweeps, times = kitti.read_sequence(args.path, limit=args.sweeps)
        gt = None
        if args.gt_poses:
            poses = kitti.read_poses(args.gt_poses)
            gt = kitti.poses_to_loam_positions(poses)[:len(sweeps)]
        return sweeps, gt, times
    raise SystemExit(f"unknown source {args.source}")


def cmd_run(args):
    import numpy as np
    cfg = _build_config(args)
    drv = _driver(args, cfg)
    t0 = time.perf_counter()
    gt = None
    if args.source == "bag":
        # full bag replay: clouds + IMU, message order (--imu-topic
        # mirrors the hector launch's IMU remap)
        drv.run_bag(args.path, cloud_topic=args.topic,
                    imu_topic=args.imu_topic)
    else:
        sweeps, gt, times = _load_sweeps(args, cfg)
        for i, pts in enumerate(sweeps):
            outs = drv.process_sweep(pts)
            if outs is not None and args.verbose:
                pose = np.asarray(outs.fused_pose)
                print(f"sweep {i}: pos=({pose[3]:+.3f}, {pose[4]:+.3f}, "
                      f"{pose[5]:+.3f})", file=sys.stderr)
    wall = time.perf_counter() - t0

    est = drv.positions()
    report = {"sweeps": len(est), "wall_s": round(wall, 3),
              "sweeps_per_sec": round(len(est) / max(wall, 1e-9), 2)}
    if gt is not None and len(est):
        from loam_velodyne_torch.eval.metrics import ate_rmse, rpe_rmse
        k = min(len(est), len(gt))
        report["ate_m"] = round(ate_rmse(est[:k], gt[:k], align=True), 4)
        report["rpe_m"] = round(rpe_rmse(est[:k], gt[:k]), 4)
    if args.out_traj:
        drv.export_tum(args.out_traj)
        report["trajectory"] = args.out_traj
    if args.out_map:
        from loam_velodyne_torch.io.pcd import write_pcd
        from loam_velodyne_torch.models.mapping import surround_map
        smap = surround_map(drv.engine.state.mapping, cfg)
        write_pcd(args.out_map, smap.xyz[smap.mask].cpu().numpy())
        report["map"] = args.out_map
    if args.out_full_map:
        from loam_velodyne_torch.io.pcd import write_pcd
        from loam_velodyne_torch.models.mapping import full_map
        xyz, mask = full_map(drv.engine.state.mapping, cfg)
        write_pcd(args.out_full_map, xyz[mask].cpu().numpy())
        report["full_map"] = args.out_full_map
    if args.out_plot:
        from loam_velodyne_torch.eval.viz import plot_trajectory
        plot_trajectory(drv.positions(), args.out_plot, gt=gt)
        report["plot"] = args.out_plot
    if args.checkpoint:
        drv.save_checkpoint(args.checkpoint)
        report["checkpoint"] = args.checkpoint
    print(json.dumps(report))


REFERENCE_TEST_DATA_URL = ("https://dl.dropboxusercontent.com/s/"
                           "y4hn486461tfmpm/velodyne_loam_test_data.tar.gz")
REFERENCE_TEST_DATA_MD5 = "3d5194e6981975588b7a93caebf79ba4"


def _fetch_reference_bag(cache_dir: str) -> str | None:
    """Try to fetch the reference's MD5-pinned test capture (the bag its
    golden test replays, reference CMakeLists.txt:55-57). Returns a bag
    path, or None when the environment has no egress / the download
    fails — callers fall back to locally mounted data."""
    import glob
    import hashlib
    import tarfile
    import urllib.request

    os.makedirs(cache_dir, exist_ok=True)
    bags = glob.glob(os.path.join(cache_dir, "**", "*.bag"), recursive=True)
    if bags:
        return sorted(bags)[0]
    tarball = os.path.join(cache_dir, "velodyne_loam_test_data.tar.gz")
    try:
        if not os.path.exists(tarball):
            with urllib.request.urlopen(REFERENCE_TEST_DATA_URL,
                                        timeout=30) as r, \
                    open(tarball + ".part", "wb") as f:
                while chunk := r.read(1 << 20):
                    f.write(chunk)
            os.replace(tarball + ".part", tarball)
        md5 = hashlib.md5()
        with open(tarball, "rb") as f:
            while chunk := f.read(1 << 20):
                md5.update(chunk)
        if md5.hexdigest() != REFERENCE_TEST_DATA_MD5:
            print(f"test-data md5 mismatch ({md5.hexdigest()}), ignoring",
                  file=sys.stderr)
            return None
        with tarfile.open(tarball) as t:
            t.extractall(cache_dir, filter="data")
        bags = glob.glob(os.path.join(cache_dir, "**", "*.bag"),
                         recursive=True)
        return sorted(bags)[0] if bags else None
    except Exception as e:                       # no egress, DNS, 404, ...
        print(f"reference test-data download unavailable: {e}",
              file=sys.stderr)
        return None


def cmd_validate(args):
    """One-command real-data validation (the reference's golden-bag
    rostest, tests/bag_test:42-47, data pinned in CMakeLists.txt:52-70):
    resolve a real capture, replay it through the full pipeline, and gate
    the trajectory against a recorded golden trace. Without a golden
    (first run) it records one; with --record it re-records deliberately.
    The golden's format is the JAX command's, so a golden that either
    package records gates the other.

    Capture resolution order: --path, $LOAM_TEST_BAG (rosbag),
    $LOAM_PCAP (pcap), $LOAM_KITTI_SEQ [+ $LOAM_KITTI_POSES] (KITTI
    velodyne dir), then the reference's MD5-pinned download (needs
    network egress)."""
    import numpy as np
    cfg = _build_config(args)

    source, path = args.source, args.path
    gt_poses = args.gt_poses or os.environ.get("LOAM_KITTI_POSES")
    if not path:
        if os.environ.get("LOAM_TEST_BAG"):
            source, path = "bag", os.environ["LOAM_TEST_BAG"]
        elif os.environ.get("LOAM_PCAP"):
            source, path = "pcap", os.environ["LOAM_PCAP"]
        elif os.environ.get("LOAM_KITTI_SEQ"):
            source, path = "kitti", os.environ["LOAM_KITTI_SEQ"]
        else:
            path = _fetch_reference_bag(args.cache_dir)
            source = "bag"
            if path is None:
                raise SystemExit(
                    "no validation capture available: pass --path, or mount "
                    "one via LOAM_TEST_BAG=<file.bag> / LOAM_PCAP=<cap.pcap>"
                    " / LOAM_KITTI_SEQ=<velodyne dir> (optionally "
                    "LOAM_KITTI_POSES=<poses.txt>), or allow network egress "
                    "for the reference's pinned test data "
                    f"({REFERENCE_TEST_DATA_URL})")
    if source == "synthetic":                   # --path given: infer type
        ext = os.path.splitext(path)[1].lower()
        source = {"": "kitti", ".bag": "bag", ".pcap": "pcap",
                  ".pcapng": "pcap"}.get(ext, "bag")

    drv = _driver(args, cfg)
    t0 = time.perf_counter()
    gt = None
    if source == "bag":
        drv.run_bag(path, cloud_topic=args.topic, imu_topic=args.imu_topic)
    else:
        ns = argparse.Namespace(source=source, path=path, sweeps=args.sweeps,
                                topic=args.topic, gt_poses=gt_poses,
                                calibration=None, azimuth=900, speed=1.0)
        sweeps, gt, _ = _load_sweeps(ns, cfg)
        for pts in sweeps:
            drv.process_sweep(pts)
    wall = time.perf_counter() - t0

    est = drv.positions()
    report = {"source": source, "path": path, "sweeps": len(est),
              "wall_s": round(wall, 3),
              "sweeps_per_sec": round(len(est) / max(wall, 1e-9), 2)}
    from loam_velodyne_torch.eval.metrics import ate_rmse
    if gt is not None and len(est):
        k = min(len(est), len(gt))
        report["ate_vs_gt_m"] = round(ate_rmse(est[:k], gt[:k], align=True), 4)

    golden = args.golden or path + ".golden.npz"
    if os.path.exists(golden) and not args.record:
        with np.load(golden) as g:
            ref = g["positions"]
        if ref.shape[0] != est.shape[0]:
            report["golden_note"] = (f"golden has {ref.shape[0]} sweeps, "
                                     f"run produced {est.shape[0]}")
        k = min(len(ref), len(est))
        ate = ate_rmse(est[:k], ref[:k], align=False)
        report["golden"] = golden
        report["ate_vs_golden_m"] = round(ate, 4)
        report["ok"] = bool(ate <= args.ate_tol)
        print(json.dumps(report))
        if not report["ok"]:
            raise SystemExit(
                f"trajectory drifted {ate:.4f} m RMS from the golden trace "
                f"(tolerance {args.ate_tol}); re-record deliberately with "
                "--record if this is an intended change")
    else:
        np.savez_compressed(golden, positions=est,
                            trajectory=np.stack(drv.trajectory)
                            if drv.trajectory else np.zeros((0, 6)))
        report["golden"] = golden
        report["recorded"] = True
        report["ok"] = True
        print(json.dumps(report))


def cmd_profile(args):
    """Record a device trace (torch.profiler, Chrome trace) over N
    sweeps after a warm-up."""
    cfg = _build_config(args)
    from loam_velodyne_torch.io import synthetic
    from loam_velodyne_torch.utils.profiling import device_trace
    sweeps, _, _ = synthetic.generate_sequence(args.sweeps + args.warmup,
                                               lidar=cfg.lidar,
                                               n_azimuth=args.azimuth)
    args.system_delay = 0
    drv = _driver(args, cfg)
    for pts in sweeps[:args.warmup]:
        drv.process_sweep(pts)
    with device_trace(args.out):
        for pts in sweeps[args.warmup:]:
            drv.process_sweep(pts)
    print(json.dumps({"trace_dir": args.out, "sweeps": args.sweeps,
                      "mean_step_ms": round(
                          1e3 * sum(drv.step_times[args.warmup:])
                          / max(args.sweeps, 1), 2)}))


def cmd_info(args):
    import torch
    from loam_velodyne_torch import __version__
    from loam_velodyne_torch.config import LIDAR_PRESETS
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                    for i in range(n)],
        "backend": "cuda" if n else "cpu",
        "lidar_presets": sorted(LIDAR_PRESETS),
    }, indent=2))


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="loam-torch",
        description="LOAM in PyTorch with CUDA kernels for Hopper (the "
                    "loam-tpu command's bench is not ported yet: it waits "
                    "for a benchmark of the port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run the pipeline over a sweep source")
    runp.add_argument("--source",
                      choices=["synthetic", "bag", "pcap", "kitti"],
                      default="synthetic")
    runp.add_argument("--path", help="input file/dir for bag/pcap/kitti")
    runp.add_argument("--gt-poses",
                      help="KITTI ground-truth poses file (ATE/RPE report)")
    runp.add_argument("--calibration",
                      help="per-unit laser calibration (JSON/YAML) for pcap")
    runp.add_argument("--topic", default="/velodyne_points")
    runp.add_argument("--imu-topic", default="/imu/data")
    runp.add_argument("--out-plot", help="write trajectory PNG here")
    runp.add_argument("--out-full-map", help="write full map PCD here")
    runp.add_argument("--lidar", default="VLP-16")
    runp.add_argument("--sweeps", type=int, default=20)
    runp.add_argument("--azimuth", type=int, default=900)
    runp.add_argument("--speed", type=float, default=1.0)
    runp.add_argument("--system-delay", type=int, default=0)
    runp.add_argument("--set", action="append", metavar="KEY=VALUE",
                      help="config override, e.g. odometry.max_iterations=10")
    runp.add_argument("--out-traj", help="write TUM trajectory here")
    runp.add_argument("--out-map", help="write surround map PCD here")
    runp.add_argument("--checkpoint", help="save engine state here")
    runp.add_argument("--verbose", action="store_true")
    _device_flag(runp)
    runp.set_defaults(fn=cmd_run)

    valp = sub.add_parser(
        "validate",
        help="replay a real capture and gate against a golden trace")
    valp.add_argument("--source",
                      choices=["synthetic", "bag", "pcap", "kitti"],
                      default="synthetic",
                      help="capture type; inferred from --path/env if left "
                           "at the default")
    valp.add_argument("--path", help="capture file/dir (else LOAM_TEST_BAG/"
                                     "LOAM_PCAP/LOAM_KITTI_SEQ env vars, "
                                     "else the reference's pinned download)")
    valp.add_argument("--golden", help="golden trace (default: "
                                       "<capture>.golden.npz)")
    valp.add_argument("--record", action="store_true",
                      help="(re-)record the golden instead of comparing")
    valp.add_argument("--ate-tol", type=float, default=0.05,
                      help="max RMS deviation vs the golden trace (m)")
    valp.add_argument("--cache-dir",
                      default=os.path.join(_ROOT, ".validation_data"))
    valp.add_argument("--topic", default="/velodyne_points")
    valp.add_argument("--imu-topic", default="/imu/data")
    valp.add_argument("--gt-poses")
    valp.add_argument("--lidar", default="VLP-16")
    valp.add_argument("--sweeps", type=int, default=10 ** 6)
    valp.add_argument("--system-delay", type=int, default=0)
    valp.add_argument("--set", action="append", metavar="KEY=VALUE")
    _device_flag(valp)
    valp.set_defaults(fn=cmd_validate)

    profp = sub.add_parser("profile",
                           help="capture a device trace over N sweeps")
    profp.add_argument("--sweeps", type=int, default=4)
    profp.add_argument("--warmup", type=int, default=3)
    profp.add_argument("--azimuth", type=int, default=900)
    profp.add_argument("--lidar", default="VLP-16")
    profp.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                     "loam_trace"))
    profp.add_argument("--set", action="append", metavar="KEY=VALUE")
    _device_flag(profp)
    profp.set_defaults(fn=cmd_profile)

    infop = sub.add_parser("info", help="environment and presets")
    infop.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"error: {e}")


if __name__ == "__main__":
    main()
