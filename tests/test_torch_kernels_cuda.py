"""The four CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package's modules, so they run on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX.)

Tolerance: none. Each kernel computes the same float32 operations in
the same order as its plain version (compiled with -fmad=false), so
integer and float outputs must be equal.
"""

import zlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from loam_velodyne_torch.ops import (corresp_kernel, greedy_kernel,
                                     grid_kernel, knn_kernel)

pytestmark = pytest.mark.cuda


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _equal(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# K2 cases: name -> (rows, W). "main" is the VLP-16 main path (96 rows
# of 384), "hdl64" HDL-64E's (384 rows of 512), "w200" a W that is not a
# multiple of 32, "w1024" the kernel's widest; the rest are main-path
# rows with one thing forced.
GREEDY_CASES = {
    "main": (96, 384), "hdl64": (384, 512), "w200": (16, 200),
    "spans": (4, 384), "w200_spans": (4, 200), "w1024_spans": (4, 1024),
    "repeat": (8, 384),
    "all_picked0": (8, 384), "quota_early": (8, 384),
    "negative_extents": (8, 384), "few_usable": (8, 384),
}
# Columns whose spans (extents 5) cross a 32-column word boundary (31,
# 64, 127, 160, W - 10) or are clipped at column 0 or W - 1; 2 and W - 3
# fall in earlier spans (negative: counted from W).
SPAN_COLUMNS = [31, 0, -1, 64, 127, 2, -3, 160, -10]


def greedy_case(name: str, corner: bool, k: int, device) -> tuple:
    """K2's arguments for one case, K candidates per row, from a numpy
    seed: curvature, rejected points (picked0), extents and the region
    as in features._all_labels; the candidates are the K best scores of
    the usable in-region points, as there.
    - spans: the first candidates are SPAN_COLUMNS, all usable;
    - repeat: candidates 1 and 5-7 repeat candidates 0 and 4;
    - all_picked0: row 0 is rejected whole;
    - quota_early: no suppression, so the quota fills in its first steps;
    - few_usable: few points pass the threshold, so most rows run out of
      usable candidates before the quota fills (as on real sweeps);
    - negative_extents: extents in [-3, 5], so some spans are empty;
      candidate 6 repeats candidate 0, whose span leaves its own column
      out, so the column can be picked twice (the later label wins)."""
    rows, w = GREEDY_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + k + 7 * corner)
    curv = rng.exponential(0.1, size=(rows, w)).astype(np.float32)
    if name == "few_usable":
        curv = curv * np.float32(0.3) if corner else curv + np.float32(0.095)
    picked0 = rng.random((rows, w)) < 0.1
    lo_ext = -3 if name == "negative_extents" else 0
    left = rng.integers(lo_ext, 6, size=(rows, w)).astype(np.int32)
    right = rng.integers(lo_ext, 6, size=(rows, w)).astype(np.int32)
    in_region = rng.random((rows, w)) < 0.9
    if name == "all_picked0":
        picked0[0] = True
    if name == "quota_early":
        left[:], right[:] = 0, 0
    scores = np.where(in_region & ~picked0, curv if corner else -curv, -np.inf)
    order = np.argsort(-scores, axis=1, kind="stable")
    cand = order[:, :k].astype(np.int32)
    ok = np.isfinite(np.take_along_axis(scores, order, 1)[:, :k])
    if name.endswith("spans"):
        cols = np.array(SPAN_COLUMNS) % w
        curv[:, cols] = 1.0 if corner else 0.0
        picked0[:, cols] = False
        left[:, cols], right[:, cols] = 5, 5
        cand[:, :len(cols)], ok[:, :len(cols)] = cols, True
    if name == "repeat":
        cand[:, 1], cand[:, 5:8] = cand[:, 0], cand[:, 4:5]
        ok[:, 1], ok[:, 5:8] = ok[:, 0], ok[:, 4:5]
    if name == "negative_extents":
        left[np.arange(rows), cand[:, 0]] = -1
        cand[:, 6], ok[:, 6] = cand[:, 0], ok[:, 0]
    quota, sharp = (20, 2) if corner else (4, 0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(curv), t(cand), t(ok), t(picked0), t(left), t(right), 0.1,
            quota, sharp, corner)


@pytest.mark.parametrize("starts", ["ragged", "duplicate_and_last"])
def test_grid_windows(starts):
    dev = _device()
    rng = np.random.default_rng(1)
    n, p = 32768, 2048
    cols = torch.from_numpy(rng.normal(size=(4, n + p)).astype(np.float32)).to(dev)
    if starts == "ragged":
        s = np.sort(rng.integers(0, n, size=16)).astype(np.int32)
        s[0], s[-1] = 0, n
    else:
        s = np.array([0, 0, 7, 7, n, n], np.int32)
    s = torch.from_numpy(s).to(dev)
    _equal([grid_kernel.grid_windows(cols, s, p)],
           [grid_kernel.grid_windows_plain(cols, s, p)])


@pytest.mark.parametrize("p", [2047, 1001, 5])
def test_grid_windows_ragged_p_and_clamped_starts(p):
    """P not a multiple of 4 (a masked tail), and starts below 0 and
    beyond Npad - P, which the kernel clamps as a dynamic slice does."""
    dev = _device()
    rng = np.random.default_rng(p)
    npad = 4099
    cols = torch.from_numpy(rng.normal(size=(4, npad)).astype(np.float32)).to(dev)
    s = np.array([-7, 0, 3, npad - p - 1, npad - p, npad - p + 1, npad, 1 << 30],
                 np.int32)
    s = torch.from_numpy(s).to(dev)
    _equal([grid_kernel.grid_windows(cols, s, p)],
           [grid_kernel.grid_windows_plain(cols, s, p)])


@pytest.mark.parametrize("corner", [True, False], ids=["corner", "flat"])
@pytest.mark.parametrize("name", list(GREEDY_CASES))
def test_greedy_pick_rows_cases(name, corner):
    dev = _device()
    args = greedy_case(name, corner, 96 if corner else 64, dev)
    _equal(greedy_kernel.greedy_pick_rows(*args),
           greedy_kernel.greedy_pick_rows_plain(*args))


@pytest.mark.parametrize("w,k", [(1025, 64), (384, 257)])
def test_greedy_pick_rows_refuses_beyond_the_kernel(w, k):
    dev = _device()
    args = (torch.zeros((2, w), device=dev),
            torch.zeros((2, k), dtype=torch.int32, device=dev),
            torch.zeros((2, k), dtype=torch.bool, device=dev),
            torch.zeros((2, w), dtype=torch.bool, device=dev),
            torch.zeros((2, w), dtype=torch.int32, device=dev),
            torch.zeros((2, w), dtype=torch.int32, device=dev),
            0.1, 4, 0, False)
    with pytest.raises(ValueError, match="W <= 1024 and K <= 256"):
        greedy_kernel.greedy_pick_rows(*args)


@pytest.mark.parametrize("corner", [True, False], ids=["corner", "flat"])
@pytest.mark.parametrize("no_candidates", [False, True],
                         ids=["candidates", "empty"])
def test_greedy_pick_rows(corner, no_candidates):
    dev = _device()
    rng = np.random.default_rng(3)
    rows, w = 96, 384
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    curv = t(rng.exponential(0.1, size=(rows, w)).astype(np.float32))
    picked0 = t(rng.random((rows, w)) < 0.1)
    left = t(rng.integers(0, 6, size=(rows, w)).astype(np.int32))
    right = t(rng.integers(0, 6, size=(rows, w)).astype(np.int32))
    in_region = t(rng.random((rows, w)) < (0.0 if no_candidates else 0.9))
    steps, quota, sharp = (96, 20, 2) if corner else (64, 4, 0)
    scores = torch.where(in_region & ~picked0, curv if corner else -curv,
                         float("-inf"))
    top, cand = torch.sort(scores, dim=1, descending=True, stable=True)
    args = (curv, cand[:, :steps].to(torch.int32).contiguous(),
            torch.isfinite(top[:, :steps]).contiguous(), picked0, left, right,
            0.1, quota, sharp, corner)
    _equal(greedy_kernel.greedy_pick_rows(*args),
           greedy_kernel.greedy_pick_rows_plain(*args))


@pytest.mark.parametrize("surf,nq,m,frac", [
    (False, 256, 2048, 0.8), (True, 512, 8192, 0.8), (True, 128, 1024, 1.0),
    (False, 128, 512, 0.0),
    # the VLP-16 main-path shapes
    (False, 256, 1920, 0.8), (True, 384, 8192, 0.8),
    # ragged: neither nq nor M a multiple of the query tile or the chunk
    (True, 130, 1000, 0.8), (False, 130, 1000, 0.8), (True, 1, 7, 1.0),
    # every row masked at the surf width
    (True, 384, 8192, 0.0)],
    ids=["corner", "surf", "dense", "empty_mask", "corner_main", "surf_main",
         "ragged_surf", "ragged_corner", "one_query", "surf_all_masked"])
def test_corresp_search(surf, nq, m, frac):
    dev = _device()
    rng = np.random.default_rng(11)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    q = t((rng.normal(size=(nq, 3)) * 5).astype(np.float32))
    ref = t((rng.normal(size=(m, 3)) * 5).astype(np.float32))
    ring = t(rng.integers(0, 16, size=m).astype(np.int32))
    mask = t(rng.random(m) < frac)
    _equal(corresp_kernel.corresp_search(q, ref, ring, mask, 2.5, surf),
           corresp_kernel.corresp_search_plain(q, ref, ring, mask, 2.5, surf))


@pytest.mark.parametrize("case", ["random", "sentinel", "duplicates"])
def test_grouped_window_knn(case):
    dev = _device()
    rng = np.random.default_rng(7)
    qg = (rng.normal(size=(32, 128, 3)) * 5).astype(np.float32)
    win = (rng.normal(size=(32, 1024, 3)) * 5).astype(np.float32)
    if case == "sentinel":
        win[:, 1:] = 1e8
    elif case == "duplicates":
        win[:, 512:] = win[:, :512]
    qg, win = torch.from_numpy(qg).to(dev), torch.from_numpy(win).to(dev)
    _equal(knn_kernel.grouped_window_knn(qg, win, 5),
           knn_kernel.grouped_window_knn_plain(qg, win, 5))


@pytest.mark.parametrize("t,g,w", [
    (16, 128, 1024),   # the VLP-16 corner stack (T=16)
    (3, 20, 1024),     # g < 32, not a multiple of the query tile
    (5, 13, 1000),     # W not a multiple of the 16 lanes of a query
    (2, 128, 5),       # W = k: fewer columns than lanes
    (1, 1, 4100),      # window above 48 KB of shared memory
])
def test_grouped_window_knn_shapes(t, g, w):
    dev = _device()
    rng = np.random.default_rng(t * 1000 + g + w)
    qg = (rng.normal(size=(t, g, 3)) * 5).astype(np.float32)
    win = (rng.normal(size=(t, w, 3)) * 5).astype(np.float32)
    win[:, w // 2:] = 1e8                    # padding rows at the sentinel
    qg, win = torch.from_numpy(qg).to(dev), torch.from_numpy(win).to(dev)
    _equal(knn_kernel.grouped_window_knn(qg, win, 5),
           knn_kernel.grouped_window_knn_plain(qg, win, 5))


def _device_ops(fn) -> list[list[str]]:
    """The device operations three profiles of one call of ``fn`` each
    saw, by name. The profiler now and then drops a device event, so a
    call puts N operations on the card when no profile saw more than N
    and at least one saw N."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen.append([e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA])
    return seen


def test_corresp_search_launches_four_device_ops():
    """A K3 call is one memset and three kernels, nothing around them."""
    dev = _device()
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = (t((rng.normal(size=(384, 3)) * 5).astype(np.float32)),
            t((rng.normal(size=(8192, 3)) * 5).astype(np.float32)),
            t(rng.integers(0, 16, size=8192).astype(np.int32)),
            t(rng.random(8192) < 0.8), 2.5, True)
    seen = _device_ops(lambda: corresp_kernel.corresp_search(*args))
    assert max(map(len, seen)) == 4, seen


@pytest.mark.parametrize("corner", [True, False], ids=["corner", "flat"])
def test_greedy_pick_rows_launches_one_device_op(corner):
    """A K2 call is its one kernel, nothing around it."""
    dev = _device()
    args = greedy_case("main", corner, 96 if corner else 64, dev)
    seen = _device_ops(lambda: greedy_kernel.greedy_pick_rows(*args))
    assert max(map(len, seen)) == 1, seen


def test_wrappers_count_their_launches():
    dev = _device()
    before = knn_kernel.grouped_window_knn.launches
    qg = torch.zeros((1, 8, 3), device=dev)
    win = torch.ones((1, 64, 3), device=dev)
    knn_kernel.grouped_window_knn(qg, win, 5)
    knn_kernel.grouped_window_knn_plain(qg, win, 5)
    assert knn_kernel.grouped_window_knn.launches == before + 1
    before = corresp_kernel.corresp_search.launches
    args = (torch.zeros((4, 3), device=dev), torch.ones((9, 3), device=dev),
            torch.zeros(9, dtype=torch.int32, device=dev),
            torch.ones(9, dtype=torch.bool, device=dev), 2.5, True)
    corresp_kernel.corresp_search(*args)
    corresp_kernel.corresp_search_plain(*args)
    assert corresp_kernel.corresp_search.launches == before + 1
    before = greedy_kernel.greedy_pick_rows.launches
    args = greedy_case("spans", True, 32, dev)
    greedy_kernel.greedy_pick_rows(*args)
    greedy_kernel.greedy_pick_rows_plain(*args)
    assert greedy_kernel.greedy_pick_rows.launches == before + 1
    before = grid_kernel.grid_windows.launches
    cols, s = torch.ones((4, 64), device=dev), torch.zeros(2, dtype=torch.int32,
                                                           device=dev)
    grid_kernel.grid_windows(cols, s, 16)
    grid_kernel.grid_windows_plain(cols, s, 16)
    assert grid_kernel.grid_windows.launches == before + 1


# Lane forms (the batched replay): each against its plain twin, which
# runs the plain version lane by lane, at the B = 8 main-path shapes of
# tools/kernel_times.py::lane_inputs, and reached from a vmapped wrapper.
LANE_FORMS = {
    "grid_lanes": (grid_kernel.grid_windows_lanes,
                   grid_kernel.grid_windows_lanes_plain,
                   grid_kernel.grid_windows),
    "greedy_corner_lanes": (greedy_kernel.greedy_pick_rows_lanes,
                            greedy_kernel.greedy_pick_rows_lanes_plain,
                            greedy_kernel.greedy_pick_rows),
    "greedy_flat_lanes": (greedy_kernel.greedy_pick_rows_lanes,
                          greedy_kernel.greedy_pick_rows_lanes_plain,
                          greedy_kernel.greedy_pick_rows),
    "corresp_corner_lanes": (corresp_kernel.corresp_search_lanes,
                             corresp_kernel.corresp_search_lanes_plain,
                             corresp_kernel.corresp_search),
    "corresp_surf_lanes": (corresp_kernel.corresp_search_lanes,
                           corresp_kernel.corresp_search_lanes_plain,
                           corresp_kernel.corresp_search),
    "knn_corner_lanes": (knn_kernel.grouped_window_knn_lanes,
                         knn_kernel.grouped_window_knn_lanes_plain,
                         knn_kernel.grouped_window_knn),
    "knn_surf_lanes": (knn_kernel.grouped_window_knn_lanes,
                       knn_kernel.grouped_window_knn_lanes_plain,
                       knn_kernel.grouped_window_knn),
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def lane_cases():
    from loam_velodyne_torch.tools import kernel_times
    return kernel_times.lane_inputs(_device(), seed=3, lanes=8)


@pytest.mark.parametrize("case", list(LANE_FORMS))
def test_lane_form_main_path(case, lane_cases):
    """B = 8 at the VLP-16 main-path shapes (K2 768 rows, K4 128 / 256
    groups), bit-equal to the plain twin; one launch, counted on the
    kernel's wrapper."""
    lane_form, plain, single = LANE_FORMS[case]
    args = lane_cases[case]
    before = single.launches
    _equal(_as_tuple(lane_form(*args)), _as_tuple(plain(*args)))
    assert single.launches == before + 1


@pytest.mark.parametrize("case", list(LANE_FORMS))
def test_lane_form_reached_under_vmap(case, lane_cases):
    """The single-lane wrapper under torch.func.vmap reaches the lane form
    through its custom op (no per-lane fallback) and gives the plain
    twin's outputs."""
    from loam_velodyne_torch.parallel.replay import no_vmap_fallback
    _, plain, single = LANE_FORMS[case]
    args = lane_cases[case]
    dims = tuple(0 if isinstance(a, torch.Tensor) else None for a in args)
    before = single.launches
    with no_vmap_fallback():
        got = torch.func.vmap(single, in_dims=dims)(*args)
    _equal(_as_tuple(got), _as_tuple(plain(*args)))
    assert single.launches == before + 1


def test_grid_lanes_clamp_each_start_within_its_lane():
    """Starts below 0 and beyond Npad - P in every lane, different per
    lane: each is clamped within its own lane, never into the next."""
    dev = _device()
    rng = np.random.default_rng(21)
    b, npad, p = 3, 4099, 1001
    cols = torch.from_numpy(rng.normal(size=(b, 4, npad)).astype(np.float32)).to(dev)
    s = np.array([[-7, 0, npad - p, npad, 1 << 30],
                  [npad - p + 1, 3, -1, 1 << 30, npad - p - 1],
                  [1 << 30, npad, npad - p, 0, -(1 << 30)]], np.int32)
    s = torch.from_numpy(s).to(dev)
    _equal([grid_kernel.grid_windows_lanes(cols, s, p)],
           [grid_kernel.grid_windows_lanes_plain(cols, s, p)])


@pytest.mark.parametrize("surf", [False, True], ids=["corner", "surf"])
def test_corresp_lanes_see_only_their_own_reference(surf):
    """Lane 1's reference holds a copy of lane 0's queries, lane 0's
    reference is far away: lane 0 must not find them. Ragged Q and M,
    and one lane fully masked."""
    dev = _device()
    rng = np.random.default_rng(22)
    b, nq, m = 3, 130, 1000
    q = (rng.normal(size=(b, nq, 3)) * 5).astype(np.float32)
    ref = (rng.normal(size=(b, m, 3)) * 5 + 50).astype(np.float32)
    ref[1, :nq] = q[0]
    ring = rng.integers(0, 16, size=(b, m)).astype(np.int32)
    mask = rng.random((b, m)) < 0.8
    mask[2] = False
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = (t(q), t(ref), t(ring), t(mask), 2.5, surf)
    got = corresp_kernel.corresp_search_lanes(*args)
    _equal(got, corresp_kernel.corresp_search_lanes_plain(*args))
    assert bool((got[1][0] > 100).all()) and bool(torch.isinf(got[1][2]).all())


def test_segment_sum_lanes_match_the_lanes_one_by_one():
    """The lane segment sums (one segment_reduce over the lanes laid end
    to end) equal one call per lane, bit for bit, on the card."""
    from loam_velodyne_torch.ops import voxel
    dev = _device()
    rng = np.random.default_rng(23)
    b, n, s = 8, 32768, 4001
    data = torch.from_numpy(rng.normal(size=(b, n, 5)).astype(np.float32)).to(dev)
    lengths = np.zeros((b, s), np.int64)
    for i in range(b):
        cuts = np.sort(rng.integers(0, n, size=s - 1))
        lengths[i] = np.diff(np.concatenate([[0], cuts, [n]]))
    lengths = torch.from_numpy(lengths).to(dev)
    _equal([voxel.segment_sum_lanes(data, lengths)],
           [voxel.segment_sum_lanes_plain(data, lengths)])


# The sized VLP-16 shapes: LoamConfig.sized_for_stream at the bench
# stream's padding (config.stream_cap: 14,464 rows, P = 1,152): K1 16 x
# 4 x 1,152 of 15,616 padded columns, K2 96 rows x 256; single-lane and
# at B = 8.
SIZED_CAP = 14464
SIZED_CASES = {
    "grid": (grid_kernel.grid_windows, grid_kernel.grid_windows_plain,
             (16, 4, 1152)),
    "greedy_corner": (greedy_kernel.greedy_pick_rows,
                      greedy_kernel.greedy_pick_rows_plain, (96, 256)),
    "greedy_flat": (greedy_kernel.greedy_pick_rows,
                    greedy_kernel.greedy_pick_rows_plain, (96, 256)),
}


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("case", list(SIZED_CASES))
def test_sized_vlp16_shapes(case, lanes):
    """K1 and K2 at the sized VLP-16 shapes, bit-equal to their plain
    versions (lane by lane at B = 8)."""
    from loam_velodyne_torch.config import LoamConfig
    from loam_velodyne_torch.tools import kernel_times
    dev = _device()
    cfg = LoamConfig.preset("VLP-16").sized_for_stream(SIZED_CAP)
    wrapper, plain, shape = SIZED_CASES[case]
    draws = [kernel_times.main_path_inputs(dev, 17 + i, cfg=cfg,
                                           sweep_cap=SIZED_CAP)[case]
             for i in range(lanes)]
    for args in draws:
        got = _as_tuple(wrapper(*args))
        assert tuple(got[0].shape) == shape
        _equal(got, _as_tuple(plain(*args)))
    if lanes > 1:
        args = tuple(torch.stack(v) if isinstance(v[0], torch.Tensor) else v[0]
                     for v in zip(*draws))
        lane_form, twin, _ = LANE_FORMS[case + "_lanes"]
        _equal(_as_tuple(lane_form(*args)), _as_tuple(twin(*args)))
