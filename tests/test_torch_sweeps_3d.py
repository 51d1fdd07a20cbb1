"""Port sweep parity in 3D: the cases of test_torch_sweeps.py's
check_plain_sweeps_match_seg_kernel and check_coupling_sweeps_match_seg_kernel
with dim = 3, in a file of their own so that the interpret-mode TPU
kernels of each file fit one worker."""

import pytest
import torch

from test_torch_sweeps import (
    CASES,
    IDS,
    check_coupling_sweeps_match_seg_kernel,
    check_plain_sweeps_match_seg_kernel,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("dim,boundary", CASES[2:], ids=IDS[2:])
def test_plain_sweeps_match_seg_kernel_3d(dim, boundary):
    check_plain_sweeps_match_seg_kernel(dim, boundary)


def test_coupling_sweeps_match_seg_kernel_3d():
    check_coupling_sweeps_match_seg_kernel(3)
