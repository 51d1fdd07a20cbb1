"""One short run of a cell on a card (skips without one)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.cells import load_cell
from benchmark.run import run_cell


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = run_cell(load_cell("demo_2d_v1.frames"), 4242, 1.0, False, torch.device("cuda", 0),
                    time.perf_counter(), log=lambda s: None)
    assert line["correct"], line["checked"]
    assert line["device"]["platform"] == "gpu" and line["metrics"]["peak_mem_mib"]
