"""The check's control on the card: the program with its float32 matrix
products in TF32 (the precision below the configuration's float32 with
TF32 off), at the ``vlp16-live`` cell's own size with a short window, on
three seeds, beside the program as configured. Each runs in a process of
its own, since a CUDA graph keeps the matrix-product kernels it was
captured with. The program must come out correct. The control's numbers
are read and printed: on this path they equal the program's (the switch
reaches nothing there), so the check does not come out false for it;
PERF.md keeps that open. On the card:
``python3 -m pytest loam_bench/tests -m cuda -s``."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from loam_bench import check, spec

SEEDS = [2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5]
ROOT = os.path.dirname(spec.HERE)


def _readings(tf32: int) -> list:
    out = subprocess.run(
        [sys.executable, "-m", "loam_bench.control", "--workload",
         "vlp16-live", "--seconds", "4", "--tf32", str(tf32), "--seeds",
         *map(str, SEEDS)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.cuda
def test_the_control_beside_the_program():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = spec.plan("vlp16-live").check["limits"]
    program, control = _readings(0), _readings(1)
    assert len(program) == len(control) == len(SEEDS)
    for p, c in zip(program, control):
        print(json.dumps({"seed": p["seed"], "program": p["numbers"],
                          "control": c["numbers"]}))
        assert p["correct"], p["numbers"]
        assert all(p["numbers"][k] <= limits[k] for k in check.NUMBERS)
        assert all(math.isfinite(c["numbers"][k]) for k in check.NUMBERS)
