"""``benchmark.work``'s pair count against brute force, and its bounds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import work


@pytest.mark.parametrize("dim", [2, 3])
def test_pair_count_matches_brute_force(dim):
    rng = np.random.default_rng(dim)
    spacing, h = 0.01, 0.04
    axes = [np.arange(0.2, 0.2 + 12 * spacing, spacing)] * dim
    x = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")], -1)
    x = (x + rng.uniform(-0.3, 0.3, x.shape) * spacing).astype(np.float32)
    mat = np.ones(len(x), np.int32)
    mat[::7] = 0  # boundary rows: j but never i
    mat[::11] = -1  # dead rows: neither
    xt, mt = torch.from_numpy(x), torch.from_numpy(mat)
    got = work.count_pairs(xt, mt, h, [0.0] * dim, [1.0] * dim)
    d = ((x[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    near = (d < h * h) & (mat[:, None] == 1) & (mat[None] >= 0)
    other = near & ~np.eye(len(x), dtype=bool)
    assert got == {"with_self": int(near.sum()), "fluid": int((other & (mat[None] == 1)).sum()),
                   "live": int(other.sum())}


def test_step_bound_phases():
    pairs = {"with_self": 5.0e7, "fluid": 4.0e7, "live": 4.0e7}
    for solver in ("wcsph", "legacy"):
        b = work.step_bound_ms(solver, 3, 195304, 195300, 468750, 2, pairs)
        assert set(b) == {"density", "force", "rebuild", "eos", "advance"}
        assert all(v > 0 for v in b.values())
    b = work.step_bound_ms("wcsph", 3, 195304, 195300, 468750, 1, pairs)
    assert b["force"] == pytest.approx(5.0e7 * 60 / 67e12 * 1e3)  # bound by operations
