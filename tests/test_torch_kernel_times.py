"""The bound of a kernel call counts only the reads its data needs."""

import torch

from loam_velodyne_torch.tools import kernel_times


def test_greedy_bound_reads_curv_at_candidates_and_extents_at_picks():
    # One row of 8 columns. Step 0 picks column 3 (marks 2..4); step 1
    # repeats column 3, already picked; step 2 is not usable.
    curv = torch.full((1, 8), 0.5)
    cand = torch.tensor([[3, 3, 5]], dtype=torch.int32)
    ok = torch.tensor([[True, True, False]])
    picked0 = torch.zeros((1, 8), dtype=torch.bool)
    ext = torch.ones((1, 8), dtype=torch.int32)
    args = (curv, cand, ok, picked0, ext, ext, 0.1, 20, 2, True)
    ops, nbytes = kernel_times.work("greedy_corner", args)
    assert ops == 4 * 3
    # curv at column 3 (4 B), left and right at the one pick (8 B), the
    # candidates (12 B), their flags (3 B), picked0 (8 B), and the
    # outputs: int32 labels and bool marks over 8 columns (40 B).
    assert nbytes == 4 + 8 + 12 + 3 + 8 + 40
