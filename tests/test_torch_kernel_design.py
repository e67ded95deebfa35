"""The arithmetic that the K2, K3 and K4 CUDA kernels rely on, on the CPU.

The kernels (``loam_velodyne_torch/csrc/greedy.cu``, ``corresp.cu`` and
``knn.cu``) run only on a card, so these tests rebuild their
decompositions as small numpy or torch models and hold each against the
plain PyTorch version, which is the spec:

- K2 runs one warp per row: lane l packs candidates l, l + 32, ... (the
  column, a usable bit and the span clamped to the row, 10 bits each)
  before the chain and owns the picked bits of columns [32l, 32l + 32);
  a step broadcasts the candidate, reads its column's bit from the
  owner's word, and ORs each lane's share of the span into its word;
  the labels come from the picks' bits after the chain;

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
from loam_velodyne_torch.ops.greedy_kernel import (greedy_chain_steps,
                                                  greedy_pick_rows_plain)
from loam_velodyne_torch.ops.knn_kernel import grouped_window_knn_plain
from test_torch_kernels_cuda import GREEDY_CASES, greedy_case
from test_torch_odometry import CASES, _case

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

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


FULL = 0xFFFFFFFF
FIELD = 1023                     # 10-bit column fields of a packed candidate
USABLE = 1 << 30
NO_SPAN = FIELD << 10            # lo = 1023 > hi = 0: an empty span
BASE = 32 * np.arange(32)        # each lane's first column


def _popc(x):
    return sum((x >> b) & 1 for b in range(32))


def _pack_candidates(curv, cand_idx, cand_ok, left, right, thr, corner):
    """(rows, rounds, 32): lane l of round r holds candidate 32 r + l,
    packed as the kernel packs it before the chain; a candidate that can
    never be taken (not ok, out of the row, failing the threshold) is 0."""
    rows, w = curv.shape
    k_cap = cand_idx.shape[1]
    rounds = max(1, -(-k_cap // 32))
    idx = np.full((rows, 32 * rounds), -1, np.int64)
    ok = np.zeros((rows, 32 * rounds), bool)
    idx[:, :k_cap], ok[:, :k_cap] = cand_idx, cand_ok
    usable = ok & (idx >= 0) & (idx < w)
    i = np.where(usable, idx, 0)
    c = np.take_along_axis(curv, i, 1)
    lo = i - np.take_along_axis(left, i, 1)
    hi = i + np.take_along_axis(right, i, 1)
    passes = c > thr if corner else c < thr
    a, e = np.maximum(lo, 0), np.minimum(hi, w - 1)
    span = np.where(a <= e, (a << 10) | (e << 20), NO_SPAN)
    v = np.where(usable & passes, i | span | USABLE, 0)
    return v.reshape(rows, rounds, 32)


def _span_bits(v):
    """(rows, 32): each lane's share of the broadcast spans v (rows,)."""
    a = ((v >> 10) & FIELD)[:, None] - BASE
    e = ((v >> 20) & FIELD)[:, None] - BASE
    frm = (FULL << np.clip(a, 0, 31)) & FULL
    to = FULL >> (31 - np.clip(e, 0, 31))
    return np.where((a <= e) & (e >= 0) & (a <= 31), frm & to, 0)


def _ballot_words(flags):
    """(rows, W) bool -> (rows, 32) words: bit b of lane l's word is
    column 32 l + b (the ballot of round l over a coalesced read)."""
    rows, w = flags.shape
    padded = np.zeros((rows, 1024), np.int64)
    padded[:, :w] = flags
    return (padded.reshape(rows, 32, 32) << np.arange(32)).sum(-1)


def _greedy_warp_model(curv, cand_idx, cand_ok, picked0, left, right, thr,
                       quota, sharp, corner):
    curv, cand_idx, cand_ok, picked0, left, right = (
        a.numpy().astype(np.int64) if a.dtype != torch.float32 else a.numpy()
        for a in (curv, cand_idx, cand_ok, picked0, left, right))
    rows, w = curv.shape
    cand = _pack_candidates(curv, cand_idx, cand_ok.astype(bool), left, right,
                            thr, corner)
    rounds = cand.shape[1]
    words = _ballot_words(picked0.astype(bool))
    words0 = words.copy()
    picks = np.zeros((rows, rounds), np.int64)
    n = np.zeros(rows, np.int64)
    # The chain stops at the end of a group of 8 once the quota is full
    # or the row's last usable candidate is behind it.
    usable = (cand.reshape(rows, -1) & USABLE) != 0
    last = np.where(usable.any(1), 32 * rounds - 1 - np.argmax(usable[:, ::-1], 1),
                    -1)
    active = np.full(rows, quota > 0) & (last >= 0)
    row = np.arange(rows)
    ran = np.zeros(rows, np.int64)                   # steps each chain ran
    for k in range(32 * rounds):
        ran += active
        v = cand[:, k >> 5, k & 31]                  # from lane k & 31
        i = v & FIELD
        owner = words[row, i >> 5]                   # from lane i >> 5
        take = (active & ((v & USABLE) != 0) & (((owner >> (i & 31)) & 1) == 0)
                & (n < quota))
        words |= np.where(take[:, None], _span_bits(v), 0)
        picks[:, k >> 5] |= take.astype(np.int64) << (k & 31)
        n += take
        if k & 7 == 7:
            active &= (n < quota) & (k < last)

    labels = np.zeros((rows, w), np.int32)
    before = np.zeros(rows, np.int64)
    for r in range(rounds):
        p = picks[:, r]
        hit = ((p[:, None] >> np.arange(32)) & 1) == 1             # (rows, 32)
        i = cand[:, r] & FIELD
        for lane in range(32):
            # __match_any_sync: of the picks of one column, the last writes.
            later = (hit[:, lane + 1:] & (i[:, lane + 1:] == i[:, lane:lane + 1])
                     ).any(1)
            write = hit[:, lane] & ~later
            ord_ = before + _popc(p & (FULL >> (31 - lane)))
            lab = np.where(ord_ <= sharp, 2, 1) if corner else np.full(rows, -1)
            labels[row[write], i[write, lane]] = lab[write]
        before += _popc(p)
    fresh = words & ~words0
    marks = ((fresh[:, :, None] >> np.arange(32)) & 1).reshape(rows, 1024)[:, :w]
    return torch.from_numpy(labels), torch.from_numpy(marks == 1), ran


@pytest.mark.parametrize("k", [40, 64, 96])
@pytest.mark.parametrize("corner", [True, False], ids=["corner", "flat"])
@pytest.mark.parametrize("name", list(GREEDY_CASES))
def test_warp_bit_model_matches_plain_greedy(name, corner, k):
    args = greedy_case(name, corner, k, torch.device("cpu"))
    want = greedy_pick_rows_plain(*args)
    got = _greedy_warp_model(*args)[:2]
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_)


@pytest.mark.parametrize("corner", [True, False], ids=["corner", "flat"])
@pytest.mark.parametrize("name", list(GREEDY_CASES))
def test_warp_chain_runs_the_steps_rows_need(name, corner):
    """The chain stops with the group of 8 in which the quota fills or
    the row's last usable candidate falls: it runs the steps
    greedy_chain_steps counts, rounded up to 8."""
    args = greedy_case(name, corner, 96 if corner else 64, torch.device("cpu"))
    need = greedy_chain_steps(*args).numpy()
    assert (_greedy_warp_model(*args)[2] == -(-need // 8) * 8).all()
