"""The PyTorch port runs where JAX is not installed: the port (every
module of the package) and chip_smoke.py must import neither JAX nor
the JAX package ``loam_velodyne_tpu``, at import time or when they run.

A subprocess installs an import hook that refuses ``jax``, ``jaxlib``
and ``loam_velodyne_tpu`` before importing anything; a stray import,
including one inside a function, then fails. Besides importing every
module, it drives chip_smoke's replay on the CPU at a tiny size: the
simulated sequence, the engine (every stage) and the ATE.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

MODULES = [
    "loam_velodyne_torch",
    "loam_velodyne_torch.types",
    "loam_velodyne_torch.config",
    "loam_velodyne_torch.eval",
    "loam_velodyne_torch.eval.metrics",
    "loam_velodyne_torch.io",
    "loam_velodyne_torch.io.synthetic",
    "loam_velodyne_torch.utils",
    "loam_velodyne_torch.ops",
    "loam_velodyne_torch.models",
    "loam_velodyne_torch.utils.math",
    "loam_velodyne_torch.utils.convert",
    "loam_velodyne_torch.ops.cuda_lib",
    "loam_velodyne_torch.ops.grid_kernel",
    "loam_velodyne_torch.ops.scan",
    "loam_velodyne_torch.ops.voxel",
    "loam_velodyne_torch.ops.greedy_kernel",
    "loam_velodyne_torch.ops.features",
    "loam_velodyne_torch.ops.corresp_kernel",
    "loam_velodyne_torch.ops.neighbors",
    "loam_velodyne_torch.ops.fit",
    "loam_velodyne_torch.ops.knn_kernel",
    "loam_velodyne_torch.models.odometry",
    "loam_velodyne_torch.models.mapping",
    "loam_velodyne_torch.models.fusion",
    "loam_velodyne_torch.models.engine",
    "loam_velodyne_torch.tools",
    "loam_velodyne_torch.tools.profile_step",
    "loam_velodyne_torch.tools.kernel_times",
    "chip_smoke",
]

_GUARD = """
import importlib, sys

REFUSED = ("jax", "jaxlib", "loam_velodyne_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("import of " + name + " refused")
        return None

sys.meta_path.insert(0, Refuse())
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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not loaded, loaded
print("ok")
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _GUARD, *MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_every_port_module_is_checked():
    """The list above covers every module file of the package."""
    pkg = ROOT / "loam_velodyne_torch"
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             for p in pkg.rglob("*.py")}
    found = {m[:-len(".__init__")] if m.endswith(".__init__") else m
             for m in found}
    assert found <= set(MODULES), sorted(found - set(MODULES))


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|loam_velodyne_tpu)\b",
                         re.MULTILINE)
    files = list((ROOT / "loam_velodyne_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
