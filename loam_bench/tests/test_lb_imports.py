"""No module that a run imports is JAX's or the JAX package's (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference (``oracle.py``) and the comparison (``check.py``)
import nothing of the port."""

import ast
import os
import subprocess
import sys

from loam_bench import spec

ROOT = os.path.dirname(spec.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "loam_velodyne_tpu"}

RUN = r'''
import glob, os, sys, tempfile, time
import torch
torch.set_num_threads(1)
import loam_bench.control, loam_bench.roofline, loam_bench.run as run
from loam_bench import spec
from loam_bench.tests import tiny
for p in glob.glob(os.path.join(spec.HERE, "metrics", "*.py")):
    spec.load_reader(p)
for entry in ("batched_chunk", "live"):
    root = tempfile.mkdtemp()
    run.run_cell(tiny.plan(root, entry), 7, 0.2, False, "cpu", time.time())
# The reference's worker processes import what a worker needs.
from loam_bench import check
check.references([check.Sample("s", "start", 0, 0, None, [])],
                 tiny.tiny_config()["loam"], 2)
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
'''

REFERENCE = r'''
import sys
import loam_bench.check, loam_bench.oracle
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
'''


def _top_levels(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split()[-1000:])


def test_a_run_imports_no_jax():
    names = _top_levels(RUN)
    assert "loam_velodyne_torch" in names and "loam_bench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    names = _top_levels(REFERENCE)
    assert "loam_velodyne_torch" not in names and "torch" not in names
    assert not names & FORBIDDEN


def test_no_reference_source_names_the_port_or_jax():
    for f in ("oracle.py", "check.py"):
        tree = ast.parse(open(os.path.join(spec.HERE, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".", 1)[0]
                assert top not in FORBIDDEN | {"loam_velodyne_torch"}, (f, n)
