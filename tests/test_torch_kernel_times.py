"""The bound of a kernel call counts only the reads its data needs, and
K2's plain loop counts the steps each row's pick needs."""

import torch

from loam_velodyne_torch.ops import greedy_kernel
from loam_velodyne_torch.tools import kernel_times

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)


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


def test_greedy_chain_steps_end_where_the_quota_fills():
    # Row 0 picks columns 1 and 5 at steps 1 and 3 (quota 2), so step 4
    # cannot pick; row 1's only usable candidate is its first.
    curv = torch.full((2, 8), 0.5)
    cand = torch.tensor([[1, 2, 5, 7], [1, 2, 5, 7]], dtype=torch.int32)
    ok = torch.tensor([[True, True, True, True], [True, False, False, False]])
    picked0 = torch.zeros((2, 8), dtype=torch.bool)
    ext = torch.ones((2, 8), dtype=torch.int32)
    args = (curv, cand, ok, picked0, ext, ext, 0.1, 2, 1, True)
    steps = greedy_kernel.greedy_chain_steps(*args)
    assert steps.dtype == torch.int32 and steps.tolist() == [3, 1]
    # The plain version's outputs are the same loop's.
    labels, marks = greedy_kernel.greedy_pick_rows_plain(*args)
    assert labels[0].tolist() == [0, 2, 0, 0, 0, 1, 0, 0]    # sharp quota 1
    assert marks[0].tolist() == [True, True, True, False, True, True, True,
                                 False]


def test_lane_inputs_stack_main_path_draws_and_their_bound_sums():
    """A lane form's inputs are B main-path draws (seeds seed..seed+B-1)
    on a leading lane axis; its work is the sum of its lanes'."""
    dev = torch.device("cpu")
    lanes = kernel_times.lane_inputs(dev, seed=4, lanes=2)
    one = [kernel_times.main_path_inputs(dev, seed=4 + i) for i in range(2)]
    assert set(lanes) == {case + "_lanes" for case in one[0]}
    for case in ("grid", "corresp_surf", "knn_corner"):
        args = lanes[case + "_lanes"]
        for i in range(2):
            for a, b in zip(kernel_times.lane(args, i), one[i][case]):
                assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                        else a == b)
        ops, nbytes = kernel_times.work(case + "_lanes", args)
        per = [kernel_times.work(case, one[i][case]) for i in range(2)]
        assert (ops, nbytes) == (per[0][0] + per[1][0], per[0][1] + per[1][1])
