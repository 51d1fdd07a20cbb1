"""Port sweep parity in 3D: the cases of test_torch_sweeps.py's
check_plain_sweeps_match_seg_kernel and check_coupling_sweeps_match_seg_kernel
with dim = 3, in a file of their own so that the interpret-mode TPU
kernels of each file fit one worker."""

import pytest
import torch

from test_torch_sweeps import (
    CASES_3D,
    IDS_3D,
    check_coupling_sweeps_match_seg_kernel,
    check_plain_sweeps_match_seg_kernel,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("dim,boundary,tag", CASES_3D, ids=IDS_3D)
def test_plain_sweeps_match_seg_kernel_3d(dim, boundary, tag):
    check_plain_sweeps_match_seg_kernel(dim, boundary, tag)


def test_coupling_sweeps_match_seg_kernel_3d():
    check_coupling_sweeps_match_seg_kernel(3)


def test_coupling_sweeps_match_seg_kernel_ragged_3d():
    check_coupling_sweeps_match_seg_kernel(3, ragged=True)
