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

import numpy as np
import pytest
import torch

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
    (False, 128, 512, 0.0)], ids=["corner", "surf", "dense", "empty_mask"])
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


def test_wrappers_count_their_launches():
    dev = _device()
    before = knn_kernel.grouped_window_knn.launches
    qg = torch.zeros((1, 8, 3), device=dev)
    win = torch.ones((1, 64, 3), device=dev)
    knn_kernel.grouped_window_knn(qg, win, 5)
    knn_kernel.grouped_window_knn_plain(qg, win, 5)
    assert knn_kernel.grouped_window_knn.launches == before + 1
