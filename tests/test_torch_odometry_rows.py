"""Odometry's GN design-matrix rows (models/odometry.py::_jacobian_rows)
in closed form, and the operations a GN iteration launches.

The rows are held to three references:
- ``_rows_autodiff``: the functorch ``vmap(grad(...))`` of the s=1 deskew
  model that the closed form replaced, kept here: bit for bit, since the
  closed form takes autodiff's products and sums in its order;
- the JAX package's ``_jacobian_rows`` (``jax.vmap(jax.grad(...))``);
- the reference's hand-expanded partials ``arx``..``atz``
  (BasicLaserOdometry.cpp:497-554), written out below as
  ``tests/reference_oracle.py``'s ``OracleOdometry`` has them inline, in
  float64 on the same float32 inputs.

Tolerance against the other two: the rows are float32 sums of products
of cosines, sines, the offset q = p - t and the coefficient c, so each
row's error is a few float32 roundings of its terms' scale:
|row - ref| <= ROW_RTOL * (|q| + 1) * |c|, with ROW_RTOL = 1e-6 (about
eight float32 epsilons; observed maximum: 2.3e-7 against the JAX rows,
which XLA's sines and cosines round otherwise on some poses, and 1.9e-7
against the float64 partials, at clouds out to 80 m and rows up to 106).
Rows of a zero coefficient are exactly zero.

The launch guard counts the operations that launch work (not views, not
allocations) of one GN iteration as ``gn_phase`` runs it (the two
``transform_to_start`` calls and ``_gn_iteration``) at VLP-16 shapes,
under a ``TorchDispatchMode``, each dispatched operation counted once.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from loam_velodyne_tpu.models import odometry as jodo
from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import odometry as todo
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils import math as lm

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

ROW_RTOL = 1e-6
B = 8


def _rows_autodiff(tf, pts, coeff):
    """The functorch rows the closed form replaced."""
    def scalar(tf_, p, c):
        return (c * todo._deskew_model(tf_, p)).sum()

    return vmap(grad(scalar), in_dims=(None, 0, 0))(tf, pts, coeff)


def _rows_oracle(tf, pts, coeff):
    """The reference's arx..atz, in float64 over all points at once."""
    tf = tf.astype(np.float64)
    x, y, z = pts.astype(np.float64).T
    cx, cy, cz = coeff.astype(np.float64).T
    srx, crx = np.sin(tf[0]), np.cos(tf[0])
    sry, cry = np.sin(tf[1]), np.cos(tf[1])
    srz, crz = np.sin(tf[2]), np.cos(tf[2])
    tx, ty, tz = tf[3:]
    arx = ((-crx * sry * srz * x + crx * crz * sry * y + srx * sry * z
            + tx * crx * sry * srz - ty * crx * crz * sry - tz * srx * sry) * cx
           + (srx * srz * x - crz * srx * y + crx * z
              + ty * crz * srx - tz * crx - tx * srx * srz) * cy
           + (crx * cry * srz * x - crx * cry * crz * y - cry * srx * z
              + tz * cry * srx + ty * crx * cry * crz - tx * crx * cry * srz) * cz)
    ary = (((-crz * sry - cry * srx * srz) * x
            + (cry * crz * srx - sry * srz) * y - crx * cry * z
            + tx * (crz * sry + cry * srx * srz)
            + ty * (sry * srz - cry * crz * srx)
            + tz * crx * cry) * cx
           + ((cry * crz - srx * sry * srz) * x
              + (cry * srz + crz * srx * sry) * y - crx * sry * z
              + tz * crx * sry - ty * (cry * srz + crz * srx * sry)
              - tx * (cry * crz - srx * sry * srz)) * cz)
    arz = (((-cry * srz - crz * srx * sry) * x
            + (cry * crz - srx * sry * srz) * y
            + tx * (cry * srz + crz * srx * sry)
            - ty * (cry * crz - srx * sry * srz)) * cx
           + (-crx * crz * x - crx * srz * y
              + ty * crx * srz + tx * crx * crz) * cy
           + ((cry * crz * srx - sry * srz) * x
              + (crz * sry + cry * srx * srz) * y
              + tx * (sry * srz - cry * crz * srx)
              - ty * (crz * sry + cry * srx * srz)) * cz)
    atx = (-(cry * crz - srx * sry * srz) * cx + crx * srz * cy
           - (crz * sry + cry * srx * srz) * cz)
    aty = (-(cry * srz + crz * srx * sry) * cx - crx * crz * cy
           - (sry * srz - cry * crz * srx) * cz)
    atz = crx * sry * cx - srx * cy - crx * cry * cz
    return np.stack([arx, ary, arz, atx, aty, atz], -1)


def _rows_jax(tf, pts, coeff):
    return np.asarray(jodo._jacobian_rows(jnp.asarray(tf), jnp.asarray(pts),
                                          jnp.asarray(coeff)))


# Clouds: points as far as `scale` m, coefficients unit directions times
# weights in (0, 1]; "zero" zeroes a third of the coefficients, "masked"
# multiplies them by a selection mask as _gn_iteration does.
CASES = {
    "near": dict(scale=5.0, coeff="dense"),
    "far": dict(scale=80.0, coeff="dense"),
    "zero": dict(scale=40.0, coeff="zero"),
    "masked": dict(scale=80.0, coeff="masked"),
}


def _draw(rng, case, n=640):
    c = CASES[case]
    tf = np.concatenate([rng.uniform(-0.5, 0.5, 3),
                         rng.uniform(-2.0, 2.0, 3)]).astype(np.float32)
    pts = (rng.uniform(-1.0, 1.0, (n, 3)) * c["scale"]).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    coeff = d * rng.uniform(0.1, 1.0, (n, 1))
    if c["coeff"] == "zero":
        coeff[rng.random(n) < 1 / 3] = 0.0
    elif c["coeff"] == "masked":
        coeff = coeff * (rng.random(n) < 0.7)[:, None]
    return tf, pts, coeff.astype(np.float32)


def _bound(tf, pts, coeff):
    q = np.linalg.norm(pts.astype(np.float64) - tf[3:], axis=-1)
    c = np.linalg.norm(coeff.astype(np.float64), axis=-1)
    return ROW_RTOL * ((q + 1.0) * c)[:, None]


def _check(got, want, tf, pts, coeff):
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bound = _bound(tf, pts, coeff)
    assert (err <= bound).all(), float((err - bound).max())
    zero = ~coeff.any(-1)
    assert (got[zero] == 0.0).all()


REFS = {"jax": _rows_jax, "oracle": _rows_oracle}


@pytest.mark.parametrize("ref", list(REFS))
@pytest.mark.parametrize("case", list(CASES))
def test_rows_single_lane(case, ref):
    rng = np.random.default_rng(sorted(CASES).index(case))
    for _ in range(4):
        tf, pts, coeff = _draw(rng, case)
        got = todo._jacobian_rows(torch.from_numpy(tf), torch.from_numpy(pts),
                                  torch.from_numpy(coeff)).numpy()
        assert got.shape == (len(pts), 6) and got.dtype == np.float32
        _check(got, REFS[ref](tf, pts, coeff), tf, pts, coeff)


@pytest.mark.parametrize("ref", list(REFS))
@pytest.mark.parametrize("case", ["far", "masked"])
def test_rows_under_vmap(case, ref):
    """B = 8 lanes, each its own pose and cloud, as the batched step runs
    the rows."""
    rng = np.random.default_rng(100 + sorted(CASES).index(case))
    lanes = [_draw(rng, case) for _ in range(B)]
    tf, pts, coeff = (np.stack(a) for a in zip(*lanes))
    assert len({tuple(t) for t in tf}) == B
    got = vmap(todo._jacobian_rows)(torch.from_numpy(tf), torch.from_numpy(pts),
                                    torch.from_numpy(coeff)).numpy()
    for b in range(B):
        args = (tf[b], pts[b], coeff[b])
        _check(got[b], REFS[ref](*args), *args)


@pytest.mark.parametrize("form", ["single", "vmap8"])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_equal_the_autodiff_rows_bit_for_bit(case, form):
    """The closed form takes reverse-mode autodiff's products and sums in
    its order: every row equals the functorch row bit for bit, signed
    zeros included, single-lane and under vmap with distinct poses."""
    rng = np.random.default_rng(200 + sorted(CASES).index(case))
    lanes = [tuple(map(torch.from_numpy, _draw(rng, case))) for _ in range(B)]
    if form == "single":
        pairs = [(todo._jacobian_rows(*lane), _rows_autodiff(*lane))
                 for lane in lanes]
    else:
        tf, pts, coeff = (torch.stack(a) for a in zip(*lanes))
        pairs = [(vmap(todo._jacobian_rows)(tf, pts, coeff),
                  vmap(_rows_autodiff)(tf, pts, coeff))]
    for got, want in pairs:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# Launch guard.
# ---------------------------------------------------------------------------

# Allocations launch nothing; a view launches nothing.
NO_LAUNCH = {"aten.empty", "aten.empty_like", "aten.empty_strided",
             "aten.new_empty", "aten.new_empty_strided", "aten.lift_fresh",
             "aten._local_scalar_dense"}

# Measured at VLP-16 shapes (single lane / B = 8): a plain iteration 445 /
# 453, the projector's (the Jacobi eigh) 4,655 / 4,664; with the autodiff
# rows in their place 1,731 / 1,739 and 5,941 / 5,950.
CEILINGS = {"plain": 700, "projector": 5400}


class Launches(TorchDispatchMode):
    """Counts the dispatched operations that launch work."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and str(func.overloadpacket) not in NO_LAUNCH:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _iteration_inputs(gen, caps):
    def cloud(n):
        return PointSet(torch.randn(n, 3, generator=gen) * 10,
                        torch.rand(n, generator=gen),
                        torch.randint(0, 16, (n,), generator=gen,
                                      dtype=torch.int32),
                        torch.rand(n, generator=gen) < 0.9)

    def idx(n, m):
        return torch.randint(0, m, (n,), generator=gen, dtype=torch.int32)

    sharp, flat = cloud(caps.sharp), cloud(384)
    lc, ls = cloud(caps.less_sharp), cloud(caps.less_flat)
    return (torch.randn(6, generator=gen) * 0.1, torch.eye(6),
            torch.zeros((), dtype=torch.bool), sharp, flat, lc, ls,
            idx(caps.sharp, caps.less_sharp), idx(caps.sharp, caps.less_sharp),
            sharp.mask, idx(384, caps.less_flat), idx(384, caps.less_flat),
            idx(384, caps.less_flat), flat.mask)


@pytest.mark.parametrize("form", ["single", "vmap8"])
@pytest.mark.parametrize("kind", list(CEILINGS))
def test_gn_iteration_launch_ceiling(kind, form):
    cfg = LoamConfig.preset("VLP-16")
    odo = cfg.odometry
    it = 0 if kind == "projector" else odo.weight_start_iteration

    def iteration(tf, mat_p, degen, sharp, flat, lc, ls, *corr):
        x_c = lm.transform_to_start(sharp.xyz, sharp.rel, tf)
        x_s = lm.transform_to_start(flat.xyz, flat.rel, tf)
        return todo._gn_iteration(tf, it, mat_p, degen, x_c, x_s, sharp, flat,
                                  lc, ls, *corr, odo,
                                  compute_projector=(it == 0))

    gen = torch.Generator().manual_seed(3)
    if form == "single":
        args = _iteration_inputs(gen, cfg.capacities)
        fn = iteration
    else:
        lanes = [_iteration_inputs(gen, cfg.capacities) for _ in range(B)]
        args = tuple(
            PointSet(*(torch.stack([lane[i][k] for lane in lanes])
                       for k in range(4)))
            if isinstance(lanes[0][i], PointSet)
            else torch.stack([lane[i] for lane in lanes])
            for i in range(len(lanes[0])))
        fn = vmap(iteration)
    with Launches() as mode:
        tf_new, _, _, _ = fn(*args)
    assert torch.isfinite(tf_new).all()
    assert mode.n <= CEILINGS[kind], mode.n
