"""K3: fused odometry correspondence search.

Replaces ``loam_velodyne_tpu/ops/pallas_corresp.py:_corresp_call``
(``_corresp_kernel``). Two passes over the previous sweep's cloud:
the nearest point j and its ring; then, in corner mode, the nearest
point with 0 < |dring| <= bracket, and in surf mode also the nearest
point on j's own ring other than j. Masked rows are no candidates, ties
go to the first column, and a result at or beyond 1e12 (no real
candidate) comes back as (0, inf). The plain version moves masked rows
to the 1e8 sentinel with ring 1<<20 instead, which gives the same
outputs.

At VLP-16 the search is 256 corner queries against 1,920 rows and 384
surf queries against 8,192: arithmetic below one launch's latency on an
H100, and too few queries for a block per query tile to fill its 132
SMs. The kernel (``csrc/corresp.cu``) splits the reference into chunks
across blocks (240 blocks for corner, 768 for surf) and reduces each
query's minimum with atomicMin on a packed 64-bit (distance bits,
column) key, exact and in any block order; masked rows are skipped in
the kernel, so a call is one memset and three kernels.

Lane form (``corresp_search_lanes``, the one launch path; a
single-lane call is B = 1): B lanes of queries, each against its own
reference, in one call; the kernel's grid has a lane axis and its keys
are per (lane, query). A lane's queries must not
see another lane's rows, so the lanes cannot fold into the queries.
"""

from __future__ import annotations

from typing import Tuple

import torch

from loam_velodyne_torch.ops import cuda_lib, lanes, launches

SENTINEL = 1e8          # masked / padding candidate coordinate
PAD_RING = 1 << 20      # ring of sentinel rows: never inside a bracket
VALID_D2 = 1e12         # every real match is closer than this

Tensor = torch.Tensor


def pairwise_sq_dist(q: Tensor, p: Tensor) -> Tensor:
    """(Q,3) x (M,3) -> (Q,M) squared distances in the difference form
    ((dx*dx + dy*dy) + dz*dz), never the |q|^2 + |p|^2 - 2qp matmul form."""
    acc = torch.zeros((q.shape[0], p.shape[0]), dtype=torch.float32,
                      device=q.device)
    for k in range(3):
        d = q[:, None, k] - p[None, :, k]
        acc = acc + d * d
    return acc


def _search_plain(query: Tensor, ref: Tensor, ring: Tensor, bracket: float,
                  surf_mode: bool) -> Tuple[Tensor, ...]:
    """The two passes on sentinel-prepared inputs; raw (j, dj, l, dl, m, dm)."""
    d2 = pairwise_sq_dist(query, ref)
    inf = float("inf")

    def argmin(d):
        # First minimal column; an all-inf row gives (0, inf).
        idx = torch.argmin(d, dim=1)
        return idx.to(torch.int32), d.gather(1, idx[:, None])[:, 0]

    j, dj = argmin(d2)
    dring = ring[None, :] - ring[j.long()][:, None]
    in_bracket = (dring != 0) & (dring.abs().to(torch.float32) <= bracket)
    l, dl = argmin(torch.where(in_bracket, d2, inf))
    if not surf_mode:
        return j, dj, l, dl, torch.zeros_like(j), torch.full_like(dj, inf)
    col = torch.arange(ref.shape[0], device=query.device)[None, :]
    same = (dring == 0) & (col != j[:, None])
    ls, dls = argmin(torch.where(same, d2, inf))
    return j, dj, ls, dls, l, dl


def _prepare(ref_xyz: Tensor, ref_ring: Tensor, ref_mask: Tensor):
    """Masked rows to the far sentinel and the pad ring."""
    ref = torch.where(ref_mask[:, None], ref_xyz, SENTINEL).contiguous()
    ring = torch.where(ref_mask, ref_ring, PAD_RING).contiguous()
    return ref, ring


def _normalize(raw) -> Tuple[Tensor, ...]:
    """A result at or beyond VALID_D2 (no real candidate) -> (0, inf)."""
    out = []
    for idx, d in zip(raw[0::2], raw[1::2]):
        real = d < VALID_D2
        out += [torch.where(real, idx, 0), torch.where(real, d, float("inf"))]
    return tuple(out)


def corresp_search_plain(query_xyz: Tensor, ref_xyz: Tensor, ref_ring: Tensor,
                         ref_mask: Tensor, bracket: float, surf_mode: bool
                         ) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of ``corresp_search``."""
    ref, ring = _prepare(ref_xyz, ref_ring, ref_mask)
    return _normalize(_search_plain(query_xyz, ref, ring, bracket, surf_mode))


def corresp_search_lanes_plain(query_xyz: Tensor, ref_xyz: Tensor,
                               ref_ring: Tensor, ref_mask: Tensor,
                               bracket: float, surf_mode: bool
                               ) -> Tuple[Tensor, ...]:
    """Plain twin of the lane form: the plain version lane by lane."""
    return lanes.per_lane(corresp_search_plain, query_xyz, ref_xyz, ref_ring,
                          ref_mask, bracket, surf_mode)


def corresp_search_lanes(query_xyz: Tensor, ref_xyz: Tensor, ref_ring: Tensor,
                         ref_mask: Tensor, bracket: float, surf_mode: bool
                         ) -> Tuple[Tensor, ...]:
    """Lane form: query (B, Q, 3), ref (B, M, 3), ring (B, M), mask
    (B, M); each lane's queries against its own reference, one call with
    a lane axis in the kernel's grid. Returns (j, dj, l, dl, m, dm), each
    (B, Q)."""
    if (query_xyz.dim() != 3 or query_xyz.shape[-1] != 3
            or ref_xyz.dim() != 3 or ref_xyz.shape[-1] != 3
            or query_xyz.shape[0] != ref_xyz.shape[0]
            or ref_ring.shape != ref_xyz.shape[:-1]
            or ref_mask.shape != ref_xyz.shape[:-1]):
        raise ValueError("corresp_search: query (Q, 3), ref (M, 3), ring and "
                         "mask (M,) expected, with one leading lane axis in "
                         "the lane form")
    if (query_xyz.dtype != torch.float32 or ref_xyz.dtype != torch.float32
            or ref_ring.dtype != torch.int32 or ref_mask.dtype != torch.bool):
        raise TypeError("corresp_search: unexpected dtypes")
    if query_xyz.device.type == "cpu":
        return corresp_search_lanes_plain(query_xyz, ref_xyz, ref_ring,
                                          ref_mask, bracket, surf_mode)
    args = tuple(t.contiguous() for t in (query_xyz, ref_xyz, ref_ring,
                                          ref_mask))
    cuda_lib.check_cuda("corresp_search", *args)
    dev = query_xyz.device
    b, nq, m = query_xyz.shape[0], query_xyz.shape[1], ref_xyz.shape[1]
    out = tuple(torch.empty((b, nq), dtype=dt, device=dev)
                for dt in (torch.int32, torch.float32) * 3)
    keys = torch.empty(3 * nq * b, dtype=torch.int64, device=dev)  # scratch
    cuda_lib.launch("loam_corresp", dev, *(t.data_ptr() for t in args),
                    keys.data_ptr(), *(t.data_ptr() for t in out), b, nq, m,
                    float(bracket), int(surf_mode))
    launches.count(corresp_search, dev)
    return out


lane_op = lanes.LaneOp(
    "corresp_search",
    "(Tensor query_xyz, Tensor ref_xyz, Tensor ref_ring, Tensor ref_mask, "
    "float bracket, bool surf_mode) -> (Tensor, Tensor, Tensor, Tensor, "
    "Tensor, Tensor)",
    corresp_search_lanes)


def corresp_search(query_xyz: Tensor, ref_xyz: Tensor, ref_ring: Tensor,
                   ref_mask: Tensor, bracket: float, surf_mode: bool
                   ) -> Tuple[Tensor, ...]:
    """Run the fused search. query (Q, 3) float32; ref (M, 3) float32,
    ring (M,) int32, mask (M,) bool. Returns (j, dj, l, dl, m, dm), each
    (Q,); rows with no real candidate come back as (0, inf). The lane
    form at B = 1, or under vmap over all lanes."""
    return lane_op(query_xyz, ref_xyz, ref_ring, ref_mask, float(bracket),
                   surf_mode)


corresp_search.launches = 0
