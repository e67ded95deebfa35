"""The PyTorch port runs where JAX is not installed: the port (every
module of the package) and chip_smoke.py must import neither JAX nor
the JAX package ``loam_velodyne_tpu``, at import time or when they run.

A subprocess installs an import hook that refuses ``jax``, ``jaxlib``
and ``loam_velodyne_tpu`` before importing anything; a stray import,
including one inside a function, then fails. Besides importing every
module, it drives chip_smoke's replay on the CPU at a tiny size: the
simulated sequence, the engine (every stage) and the ATE; the batched
replay and the multi-process replay (in a one-process gloo group); the
per-sweep driver with an IMU tracker through process_sweep, run_live,
a checkpoint round trip and registered_cloud; and the loam-torch
command (``cli.main(["run", "--device", "cpu", ...])``) on a tiny bag
and a tiny wire-format pcap; and the bench's headline line (the single
stream, both batched replays and the live latency). The modules are
found by walking the package, so a module added later is checked too.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def port_modules() -> list:
    """Every module of the package (found by walking it, so that modules
    added later are covered too), and chip_smoke."""
    import pkgutil

    import loam_velodyne_torch
    names = ["loam_velodyne_torch"] + [
        m.name for m in pkgutil.walk_packages(loam_velodyne_torch.__path__,
                                              "loam_velodyne_torch.")]
    return names + ["chip_smoke"]


_GUARD = """
import importlib, sys

REFUSED = ("jax", "jaxlib", "loam_velodyne_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("import of " + name + " refused")
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)        # one of six test workers on eight cores
for name in sys.argv[1:]:
    importlib.import_module(name)

import chip_smoke
from loam_velodyne_torch import config as C
from loam_velodyne_torch.models.engine import Engine
cfg = C.LoamConfig(
    lidar=C.LidarConfig("tiny", -15.0, 15.0, 4, max_points_per_ring=64),
    registration=C.RegistrationConfig(corner_scan_cap=32, flat_scan_cap=16),
    odometry=C.OdometryConfig(max_iterations=2, min_surface_points=10),
    mapping=C.MappingConfig(
        grid_width=5, grid_height=3, grid_depth=5, center_width=2,
        center_height=1, center_depth=2, recenter_margin=1, neighborhood=1,
        corner_cube_capacity=32, surf_cube_capacity=64,
        corner_stack_capacity=64, surf_stack_capacity=128, knn_window=64,
        knn_group=32, archive_capacity=4096, archive_append_budget=256,
        max_iterations=2, min_surface_map_points=10, min_selected=10))
xyz, mask, gt = chip_smoke.synthetic.bench_sequence(2, cfg.lidar, cap=256,
                                                    n_azimuth=64)
engine = Engine(cfg, "cpu")
packed, _ = chip_smoke.replay(engine, chip_smoke.torch.from_numpy(xyz),
                              chip_smoke.torch.from_numpy(mask))
assert packed.shape == (2, 29), packed.shape
assert bool(packed[1, 18]) and engine.sweep == 2         # mapping ran
ate = chip_smoke.ate_rmse(packed[:, 15:18].numpy(), gt, align=True)
assert ate == ate

# The batched replay: two identical lanes of the same input as one op
# stream (the vmap fallback off), and replay_sequences.
from loam_velodyne_torch.parallel import replay as batched
x, m = chip_smoke.torch.from_numpy(xyz), chip_smoke.torch.from_numpy(mask)
_, bout = batched.make_batched_chunk(cfg)(
    batched.create_states(cfg, 2, "cpu"),
    chip_smoke.RawSweep(chip_smoke.torch.stack([x, x]),
                        chip_smoke.torch.stack([m, m])))
assert bout.packed.shape == (2, 2, 29)
assert (bout.packed[:, :, 18:] == packed[None, :, 18:]).all()
pos = batched.replay_sequences(cfg, [[xyz[i][mask[i]] for i in range(2)]] * 2,
                               device="cpu", sweep_capacity=256)
assert pos.shape == (2, 2, 3)

# The multi-process replay, in a one-process gloo group.
from loam_velodyne_torch.parallel import multihost
from loam_velodyne_torch.tools import dryrun_dcn
with dryrun_dcn.reserved_port() as port:
    multihost.init(f"localhost:{port}", 1, 0)
gpos = multihost.replay_global(cfg, [[xyz[i][mask[i]] for i in range(2)]] * 2,
                               chunk=2, sweep_capacity=256, device="cpu")
chip_smoke.torch.distributed.destroy_process_group()
assert gpos.shape == (2, 2, 3) and (gpos == pos).all()

import os, tempfile
import numpy as np
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.io.imu import ImuTracker
sweeps = [xyz[i][mask[i]] for i in range(2)]

def driver(**kw):
    drv = LoamDriver(cfg, device="cpu", sweep_capacity=256, system_delay=0, **kw)
    drv.imu_tracker = ImuTracker()
    for k in range(40):
        t = -0.1 + 0.01 * k
        drv.imu_tracker.push_state(t, (0.02 * np.sin(7 * t), 0.0, 0.0), (0.05, 0.0, 0.0))
    return drv

ckpt = os.path.join(tempfile.mkdtemp(), "state.npz")
a = driver()
for pts, stamp in zip(sweeps, (0.0, 0.1)):
    a.process_sweep(pts, stamp)
b = driver(checkpoint_path=ckpt, checkpoint_every=2)
b.run_live(sweeps, (0.0, 0.1))
assert np.array_equal(np.stack(a.trajectory), np.stack(b.trajectory))
c = driver(checkpoint_path=ckpt)
assert c.resume() and c.resumed_sweeps == 2
reg_xyz, reg_mask = c.registered_cloud(sweeps[1], 0.1)
assert reg_mask.any() and np.isfinite(reg_xyz).all()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)

# The bench's headline line (every measurement of the bench) and its
# artifact.
from loam_velodyne_torch import bench
bsweeps, bgt = chip_smoke.synthetic.bench_sweeps(4, cfg.lidar, n_azimuth=64)
line = bench.headline_line(cfg, bsweeps, bgt, 2, 2, 256, "cpu")
assert bench.key_paths(line) >= {"extra.live_max_attribution.max_sweep_index"}
bench.write_artifact([line], os.path.join(tempfile.mkdtemp(), "bench.json"))

# The loam-torch command on the CPU: a tiny bag with an IMU and a tiny
# wire-format pcap.
import contextlib, io, json
from loam_velodyne_torch import cli
from loam_velodyne_torch.io.rosbag import BagWriter
from loam_velodyne_torch.tools import make_validation_pcap
d = tempfile.mkdtemp()
bag = os.path.join(d, "tiny.bag")
with BagWriter(bag, compression="lz4") as w:
    for k, pts in enumerate(sweeps):
        w.write_imu("/imu/data", 0.1 * k, (0, 0, 0, 1), (0.0, 0.0, 9.81))
        w.write_cloud("/velodyne_points", 0.1 * k, pts)
cap = os.path.join(d, "tiny.pcap")
make_validation_pcap.write_validation_pcap(cap, 2, n_az=48)
first = ("neighborhood", "recenter_margin")    # shrink before the grid
sets = []
for section in ("lidar", "registration", "odometry", "mapping", "capacities"):
    items = sorted(vars(getattr(cfg, section)).items(),
                   key=lambda kv: kv[0] not in first)
    for key, value in items:
        raw = value if isinstance(value, str) else json.dumps(value)
        sets += ["--set", f"{section}.{key}={raw}"]
for source, path, n in (("bag", bag, 2), ("pcap", cap, 2)):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["run", "--device", "cpu", "--source", source, "--path", path,
                  "--out-traj", os.path.join(d, source + ".tum"), *sets])
    rep = json.loads(out.getvalue())
    assert rep["sweeps"] == n, rep
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not loaded, loaded
print("ok")
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _GUARD, *port_modules()], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_every_port_module_is_checked():
    """The walk covers every module file of the package."""
    pkg = ROOT / "loam_velodyne_torch"
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             for p in pkg.rglob("*.py")}
    found = {m[:-len(".__init__")] if m.endswith(".__init__") else m
             for m in found}
    walked = set(port_modules())
    assert found <= walked, sorted(found - walked)
    assert {"loam_velodyne_torch.cli", "loam_velodyne_torch.io.rosbag",
            "loam_velodyne_torch.io.live"} <= walked


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|loam_velodyne_tpu)\b",
                         re.MULTILINE)
    files = list((ROOT / "loam_velodyne_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
