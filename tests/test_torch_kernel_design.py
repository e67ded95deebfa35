"""The arithmetic that the K3 and K4 CUDA kernels rely on, on the CPU.

The kernels (``loam_velodyne_torch/csrc/corresp.cu`` and ``knn.cu``) run
only on a card, so these tests rebuild their decompositions as small
torch models and hold each against the plain PyTorch version, which is
the spec:

- K3 splits the reference into column chunks across blocks and reduces
  each query's minimum with atomicMin on a packed int64 key, (float bits
  of d) << 32 | column, with masked rows skipped (staged as NaN) instead
  of moved to the sentinel;
- K4 gives each query S lanes, each keeping the top-5 of every S-th
  column, and merges the S lists lexicographically on (d, column) in a
  butterfly of rounds; each merge keeps the lesser of entry i and the
  partner's entry 4 - i, then sorts the five.

Tolerance: none. Both models compute the plain version's float32
distances, so indices and distances must be equal.
"""

import numpy as np
import pytest
import torch

from loam_velodyne_torch.ops.corresp_kernel import (corresp_search_plain,
                                                    pairwise_sq_dist)
from loam_velodyne_torch.ops.knn_kernel import grouped_window_knn_plain
from test_torch_odometry import CASES, _case

INF = float("inf")
# The kernel's "no candidate" key is the unsigned all-ones word, above
# every real key. A real key has the sign bit of d >= +0 clear, so the
# signed int64 order of real keys is their unsigned order, and int64's
# maximum plays the all-ones word here.
NONE = torch.iinfo(torch.int64).max
LOW = 0xFFFFFFFF


def _pack(d: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    bits = d.contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | col.to(torch.int64)


def _chunked_min(query, staged, cand, chunk):
    """Per query, the least key over column chunks. In a chunk, a
    thread's scan keeps the first strict minimum below +inf (a NaN
    distance never passes), which is the chunk's least key; across
    chunks, atomicMin keeps the least."""
    keys = torch.full((query.shape[0],), NONE, dtype=torch.int64)
    for c0 in range(0, staged.shape[0], chunk):
        d = pairwise_sq_dist(query, staged[c0:c0 + chunk])
        col = torch.arange(c0, c0 + d.shape[1]).expand_as(d)
        ok = cand[:, c0:c0 + d.shape[1]] & (d < INF)
        key = torch.where(ok, _pack(d, col), NONE)
        keys = torch.minimum(keys, key.min(dim=1).values)
    return keys


def _unpack(keys):
    d = (keys >> 32).to(torch.int32).view(torch.float32)
    real = (keys != NONE) & (d < 1e12)
    return (torch.where(real, keys & LOW, 0).to(torch.int32),
            torch.where(real, d, INF))


def _corresp_model(query, ref, ring, mask, bracket, surf, chunk):
    q, m = query.shape[0], ref.shape[0]
    staged = ref.clone()
    staged[~mask, 0] = float("nan")                # masked rows: x = NaN
    key_j = _chunked_min(query, staged, torch.ones((q, m), dtype=torch.bool),
                         chunk)
    has_j = key_j != NONE
    j = torch.where(has_j, key_j & LOW, 0)
    dring = ring[None, :] - ring[j][:, None]
    in_bracket = (dring != 0) & (dring.abs().to(torch.float32) <= bracket)
    if surf:
        to_l = (dring == 0) & (torch.arange(m)[None, :] != j[:, None])
        to_m = in_bracket
    else:
        to_l, to_m = in_bracket, torch.zeros_like(in_bracket)
    key_l = _chunked_min(query, staged, to_l & has_j[:, None], chunk)
    key_m = _chunked_min(query, staged, to_m & has_j[:, None], chunk)
    return _unpack(key_j) + _unpack(key_l) + _unpack(key_m)


@pytest.mark.parametrize("chunk", [32, 100, 192])
@pytest.mark.parametrize("name", list(CASES))
def test_packed_key_chunks_match_plain_corresp(name, chunk):
    c, q_xyz, _, (xyz, _, ring, mask) = _case(name)
    args = (torch.from_numpy(q_xyz), torch.from_numpy(xyz),
            torch.from_numpy(ring), torch.from_numpy(mask), 2.5, c["surf"])
    want = corresp_search_plain(*args)
    got = _corresp_model(*args, chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _lane_lists(d2, lanes, k=5):
    """(T, G, S, k) lists: lane s scans columns s, s + S, ... in order
    with a strict '<', so it keeps the k lexicographically least (d,
    column) pairs of its columns; short lanes are padded with (inf, 0)."""
    t, g, w = d2.shape
    vals = torch.full((t, g, lanes, k), INF)
    cols = torch.zeros((t, g, lanes, k), dtype=torch.int64)
    for s in range(lanes):
        own = torch.arange(s, w, lanes)
        v, order = torch.sort(d2[..., own], dim=-1, stable=True)
        n = min(k, own.numel())
        vals[:, :, s, :n] = v[..., :n]
        cols[:, :, s, :n] = own[order[..., :n]]
    return vals, cols


def _lex_sorted(vals, cols):
    """Sorted on (d, column) along the last axis."""
    by_col = torch.argsort(cols, dim=-1, stable=True)
    vals, cols = vals.gather(-1, by_col), cols.gather(-1, by_col)
    by_d = torch.argsort(vals, dim=-1, stable=True)
    return vals.gather(-1, by_d), cols.gather(-1, by_d)


def _union_least(vals, cols, pv, pc, k=5):
    """The k least pairs of both lists."""
    v, c = _lex_sorted(torch.cat([vals, pv], -1), torch.cat([cols, pc], -1))
    return v[..., :k], c[..., :k]


def _half_cleaner(vals, cols, pv, pc):
    """The kernel's merge: entry i against the partner's entry k-1-i,
    the lexicographic lesser kept (the lower half of a bitonic merge),
    then sorted."""
    rv, rc = pv.flip(-1), pc.flip(-1)
    take = (rv < vals) | ((rv == vals) & (rc < cols))
    return _lex_sorted(torch.where(take, rv, vals), torch.where(take, rc, cols))


def _butterfly_merge(vals, cols, merge):
    """Each round, lane s merges its list with lane s ^ off's."""
    lanes = vals.shape[2]
    off = 1
    while off < lanes:
        partner = torch.arange(lanes) ^ off
        vals, cols = merge(vals, cols, vals[:, :, partner], cols[:, :, partner])
        off *= 2
    assert torch.equal(vals, vals[:, :, :1].expand_as(vals))
    return vals[:, :, 0], cols[:, :, 0].to(torch.int32)


@pytest.mark.parametrize("merge", [_union_least, _half_cleaner],
                         ids=["union", "half_cleaner"])
@pytest.mark.parametrize("w", [1024, 1000])
@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("case", ["random", "sentinel", "duplicates"])
def test_lane_slices_merge_to_plain_knn(case, lanes, w, merge):
    rng = np.random.default_rng(7)
    qg = (rng.normal(size=(3, 24, 3)) * 5).astype(np.float32)
    win = (rng.normal(size=(3, w, 3)) * 5).astype(np.float32)
    if case == "sentinel":
        win[:, 1:] = 1e8
    elif case == "duplicates":
        win[:, w // 2:2 * (w // 2)] = win[:, :w // 2]
    qg, win = torch.from_numpy(qg), torch.from_numpy(win)
    d2 = torch.zeros((3, 24, w))
    for c in range(3):
        diff = qg[:, :, None, c] - win[:, None, :, c]
        d2 = d2 + diff * diff
    got = _butterfly_merge(*_lane_lists(d2, lanes), merge)
    want = grouped_window_knn_plain(qg, win, 5)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_)
