"""A symmetric eigendecomposition that never reads back from the device.

Counterpart of ``loam_velodyne_tpu/utils/linalg.py::jacobi_eigh``: the
same fixed number of cyclic Jacobi sweeps, the same rotation order
(row-cyclic over p < q), the same guards and the same output order
(ascending eigenvalues, eigenvectors as columns). One difference, on
purpose: where a[p, p] == a[q, q] (tau == 0) the JAX function takes
sign(0) = 0, so t = 0 and a[p, q] is never rotated away (a matrix
[[2, .5], [.5, 2]] keeps its diagonal as its eigenvalues); the port
takes the sign as +1 there (a 45 degree rotation, the textbook choice),
and equals the JAX function wherever tau != 0.

Why the port uses it: ``torch.linalg.eigh`` on a CUDA tensor checks its
solver's status on the host, so it synchronises with the card and
cannot be captured in a CUDA graph. This is a fixed chain of
elementwise operations on (..., n, n) tensors, batched over the leading
axes, with no data-dependent control flow: it runs unchanged under
``torch.func.vmap`` (with the vmap fallback off) and inside a captured
graph. Each operation is one elementwise kernel, so the CPU and the
card round alike (no fused multiply-add).

Cost: n(n - 1)/2 rotations a sweep, 35 small operations each, ~4,200
operations for a 6x6 at 8 sweeps (launches in eager mode, nodes in a
graph). The JAX package's ``cholesky_solve`` is not ported (the port
solves with ``torch.linalg.solve_ex``, which does not read back).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _rotate(x: Tensor, p: int, q: int, cs: Tensor, nsc: Tensor, dim: int
            ) -> Tensor:
    """x with its p-th and q-th rows (dim=-2) or columns (dim=-1)
    replaced by c*x_p - s*x_q and s*x_p + c*x_q, given cs = (c, s) and
    nsc = (-s, c) on a last axis of 2 (a + (-b) rounds as a - b)."""
    xp = x.select(dim, p).unsqueeze(-2)
    xq = x.select(dim, q).unsqueeze(-2)
    new = cs[..., None] * xp + nsc[..., None] * xq       # (..., 2, n)
    parts = [new[..., 0, :] if i == p else new[..., 1, :] if i == q
             else x.select(dim, i) for i in range(x.shape[dim])]
    return torch.stack(parts, dim=dim)


def jacobi_eigh(a: Tensor, sweeps: int = 8) -> Tuple[Tensor, Tensor]:
    """Eigendecomposition of symmetric (..., n, n) matrices by cyclic
    Jacobi. Returns (eigenvalues ascending (..., n), eigenvectors as
    columns (..., n, n)), as ``torch.linalg.eigh`` does."""
    n = a.shape[-1]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = a[..., p, q]
                app = a[..., p, p]
                aqq = a[..., q, q]
                # The rotation angle that zeroes a[p, q].
                tiny = apq.abs() < 1e-30
                tau = (aqq - app) / (2.0 * apq.masked_fill(tiny, 1e-30))
                t = (torch.copysign(torch.ones_like(tau), tau)
                     / (tau.abs() + torch.sqrt(1.0 + tau * tau)))
                t = t.masked_fill(tiny, 0.0)
                c = torch.reciprocal(torch.sqrt(1.0 + t * t))
                s = t * c
                cs = torch.stack([c, s], -1)
                nsc = torch.stack([-s, c], -1)
                a = _rotate(a, p, q, cs, nsc, dim=-2)
                a = _rotate(a, p, q, cs, nsc, dim=-1)
                v = _rotate(v, p, q, cs, nsc, dim=-1)
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(v, -1, order[..., None, :].expand(v.shape)))
