"""Odometry's closed-form GN rows on the card: bit-equal to the functorch
rows they replaced.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package:

    python -m pytest tests/test_torch_odometry_rows_cuda.py -m cuda --noconftest

``models/odometry.py::_jacobian_rows`` takes reverse-mode autodiff's
products and sums in its order, each an elementwise kernel on the card
as autograd's are, so on ``cuda:0`` it equals ``vmap(grad(...))`` of the
s=1 deskew model bit for bit (signed zeros included): 640 points with
poses up to 0.5 rad, clouds out to 80 m and a third of the coefficients
zero, single-lane and under vmap with 8 distinct poses.

Tolerance: none.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from loam_velodyne_torch.models import odometry as todo

pytestmark = pytest.mark.cuda

B = 8


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _rows_autodiff(tf, pts, coeff):
    def scalar(tf_, p, c):
        return (c * todo._deskew_model(tf_, p)).sum()

    return vmap(grad(scalar), in_dims=(None, 0, 0))(tf, pts, coeff)


def _draw(rng, dev, n=640):
    tf = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-2.0, 2.0, 3)])
    pts = rng.uniform(-80.0, 80.0, (n, 3))
    coeff = rng.normal(size=(n, 3)) * (rng.random(n) < 2 / 3)[:, None]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (tf, pts, coeff))


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("form", ["single", "vmap8"])
def test_rows_equal_the_autodiff_rows_on_the_card(form):
    dev = _device()
    rng = np.random.default_rng(1)
    lanes = [_draw(rng, dev) for _ in range(B)]
    if form == "single":
        pairs = [(todo._jacobian_rows(*lane), _rows_autodiff(*lane))
                 for lane in lanes]
    else:
        tf, pts, coeff = (torch.stack(a) for a in zip(*lanes))
        pairs = [(vmap(todo._jacobian_rows)(tf, pts, coeff),
                  vmap(_rows_autodiff)(tf, pts, coeff))]
    for got, want in pairs:
        assert got.device.type == "cuda"
        assert torch.equal(_bits(got), _bits(want))
