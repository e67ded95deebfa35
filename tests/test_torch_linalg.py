"""Port parity, the capturable eigh: loam_velodyne_torch.utils.linalg
``jacobi_eigh`` against the JAX package's ``utils/linalg.jacobi_eigh``
and against ``jnp.linalg.eigh``, on the CPU, and the port's
``degeneracy_projector`` (which runs it in float64) against the JAX
package's ``_degeneracy_projector`` (which uses ``jnp.linalg.eigh``)
and against LAPACK's float64 eigh rounded to float32 (bit for bit).

Inputs are seeded symmetric positive semi-definite 6x6 float32 matrices
of the kinds the Gauss-Newton normal matrices take: well conditioned
ones over scales 1 to 1e4, ones with an eigenvalue just either side of
the degeneracy threshold of 10 (10 +- 0.05), and rank-deficient ones
(A = M M^T with M of rank 4 or 5, zero eigenvalues).

Tolerances and why:
- Eigenvalues against the JAX Jacobi: 2e-6 of the largest eigenvalue
  (observed 7.5e-7, 0 on five of the eight cases). The same rotations in
  the same order; XLA on the CPU may contract a multiply and an add
  into one rounding where the port rounds twice.
- Eigenvalues against ``jnp.linalg.eigh`` (LAPACK's algorithm): 1e-5 of
  the largest eigenvalue (observed 1.2e-6), float32 rounding of two
  different algorithms.
- The projector V diag(keep) V^T (sign- and order-free): 1e-5 against
  either (observed 1.4e-6); its keep decisions exactly (no eigenvalue
  lies within rounding of the threshold in these cases).
- Under ``torch.func.vmap`` with the fallback off, and batched over a
  leading axis: bit-equal to the matrix-by-matrix call (the same
  elementwise operations).

Where two diagonal entries tie (a[p, p] == a[q, q], tau == 0), the JAX
``jacobi_eigh`` takes sign(0) = 0 and never rotates a[p, q] away; the
port takes +1 there. On such a matrix the port is held to
``jnp.linalg.eigh`` (as above), and the JAX function's fault is shown.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from loam_velodyne_tpu.models import odometry as jodo
from loam_velodyne_tpu.utils import linalg as jlinalg
from loam_velodyne_torch.models import odometry as todo
from loam_velodyne_torch.parallel.replay import no_vmap_fallback
from loam_velodyne_torch.utils import linalg as tlinalg

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

THRESHOLD = 10.0


def _rotation(rng, n=6):
    q, r = np.linalg.qr(rng.normal(size=(n, n)))
    return q * np.sign(np.diag(r))


def _from_spectrum(rng, w):
    q = _rotation(rng)
    a = (q * np.asarray(w, np.float64)[None, :]) @ q.T
    return ((a + a.T) / 2).astype(np.float32)


def cases():
    rng = np.random.default_rng(17)
    out = {}
    for i, scale in enumerate((1.0, 30.0, 1e3, 1e4)):
        m = rng.normal(size=(6, 6)) * np.sqrt(scale)
        out[f"spd_{i}"] = ((m @ m.T) + scale * np.eye(6)).astype(np.float32)
    for i, near in enumerate((THRESHOLD - 0.05, THRESHOLD + 0.05)):
        w = np.concatenate([[near], rng.uniform(50, 500, 5)])
        out[f"near_threshold_{i}"] = _from_spectrum(rng, w)
    for rank in (4, 5):
        m = rng.normal(size=(6, rank)) * 8.0
        a = m @ m.T
        out[f"rank_{rank}"] = ((a + a.T) / 2).astype(np.float32)
    return out


CASES = cases()


def _projector(w, v, threshold=THRESHOLD):
    keep = (w >= threshold).astype(np.float64)
    return (v * keep[None, :]) @ v.T, keep


@pytest.mark.parametrize("name", list(CASES))
def test_jacobi_eigh_matches_jax(name):
    a = CASES[name]
    w, v = (x.numpy() for x in tlinalg.jacobi_eigh(torch.from_numpy(a)))
    wj, vj = (np.asarray(x) for x in jlinalg.jacobi_eigh(jnp.asarray(a)))
    we, ve = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(a)))
    scale = float(np.abs(we).max())
    assert np.all(np.diff(w) >= 0)
    np.testing.assert_allclose(w, wj, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(w, we, rtol=0, atol=1e-5 * scale)
    p, keep = _projector(w, v)
    for wr, vr in ((wj, vj), (we, ve)):
        pr, keep_r = _projector(wr, vr)
        np.testing.assert_array_equal(keep, keep_r)
        np.testing.assert_allclose(p, pr, rtol=0, atol=1e-5)
    # Eigenvectors are orthonormal columns and diagonalize a.
    np.testing.assert_allclose(v.T @ v, np.eye(6), atol=1e-5)
    np.testing.assert_allclose(v.T @ a @ v, np.diag(w), atol=2e-5 * scale)


def test_the_cases_span_the_threshold():
    kept = {name: int((np.linalg.eigvalsh(a.astype(np.float64)) >= THRESHOLD).sum())
            for name, a in CASES.items()}
    assert kept["near_threshold_0"] == 5 and kept["near_threshold_1"] == 6
    assert kept["rank_4"] <= 4 and kept["rank_5"] <= 5
    assert kept["spd_0"] < 6 and kept["spd_3"] == 6


@pytest.mark.parametrize("name", list(CASES))
def test_degeneracy_projector_is_the_exact_one_rounded(name):
    """The projector's Jacobi runs in float64: its eigenpairs, rounded to
    float32, are LAPACK's float64 eigenpairs rounded to float32, and the
    projector built from them is the same, bit for bit."""
    a = torch.from_numpy(CASES[name])
    p, dg = todo.degeneracy_projector(a, THRESHOLD)
    w, v = (x.float() for x in torch.linalg.eigh(a.double()))
    keep = (w >= THRESHOLD).to(torch.float32)
    assert torch.equal(p, (v * keep[None, :]) @ v.T)
    assert bool(dg) == bool((keep < 0.5).any())


@pytest.mark.parametrize("name", list(CASES))
def test_degeneracy_projector_matches_jax(name):
    """The port's projector (Jacobi) against the JAX package's (LAPACK
    eigh): the matrix within 1e-5, the degenerate flag exactly."""
    a = CASES[name]
    p, dg = todo.degeneracy_projector(torch.from_numpy(a), THRESHOLD)
    pj, dgj = jodo._degeneracy_projector(jnp.asarray(a), THRESHOLD)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    assert bool(dg) == bool(dgj)


def test_batched_and_vmapped_equal_one_by_one():
    stack = torch.from_numpy(np.stack(list(CASES.values())))
    w_b, v_b = tlinalg.jacobi_eigh(stack)
    with no_vmap_fallback():
        w_v, v_v = torch.func.vmap(tlinalg.jacobi_eigh)(stack)
    for i in range(stack.shape[0]):
        w1, v1 = tlinalg.jacobi_eigh(stack[i])
        assert torch.equal(w_b[i], w1) and torch.equal(v_b[i], v1)
        assert torch.equal(w_v[i], w1) and torch.equal(v_v[i], v1)


def test_a_tied_diagonal_is_rotated():
    """[[2, .5], [.5, 2]] in the top corner of a diagonal 6x6: eigenvalues
    1.5 and 2.5, not the diagonal's 2 and 2."""
    a = np.diag([2.0, 2.0, 1.0, 20.0, 30.0, 40.0]).astype(np.float32)
    a[0, 1] = a[1, 0] = 0.5
    w, v = (x.numpy() for x in tlinalg.jacobi_eigh(torch.from_numpy(a)))
    we, ve = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(a)))
    np.testing.assert_allclose(w, we, rtol=0, atol=1e-5 * 40.0)
    np.testing.assert_allclose(_projector(w, v, 1.8)[0],
                               _projector(we, ve, 1.8)[0], rtol=0, atol=1e-5)
    wj = np.asarray(jlinalg.jacobi_eigh(jnp.asarray(a))[0])
    np.testing.assert_array_equal(wj[:3], [1.0, 2.0, 2.0])   # the JAX fault
