"""``benchmark.work``'s pair count against brute force, and its bounds."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import work


def _brute(x: np.ndarray, mat: np.ndarray, h: float) -> dict[str, int]:
    d = ((x[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    near = (d < h * h) & (mat[:, None] == 1) & (mat[None] >= 0)
    other = near & ~np.eye(len(x), dtype=bool)
    return {"with_self": int(near.sum()), "fluid": int((other & (mat[None] == 1)).sum()),
            "live": int(other.sum())}


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
    assert got == _brute(x, mat, h)


def test_step_bound_phases():
    pairs = {"with_self": 5.0e7, "fluid": 4.0e7, "live": 4.0e7}
    for solver in ("wcsph", "legacy"):
        b = work.step_bound_ms(solver, 3, 195304, 195300, 468750, 2, pairs)
        assert set(b) == {"density", "force", "rebuild", "eos", "advance"}
        assert all(v > 0 for v in b.values())
    b = work.step_bound_ms("wcsph", 3, 195304, 195300, 468750, 1, pairs)
    assert b["force"] == pytest.approx(5.0e7 * 60 / 67e12 * 1e3)  # bound by operations


# the bounds of the pure-fluid and legacy kinds, as the benchmark gave them
# before it knew the coupled kind: (arguments, phases)
PINNED = [
    (("wcsph", 3, 195304, 195300, 468750, 2, {"with_self": 5.2e7}),
     {"density": 0.019402985074626865, "force": 0.046567164179104475,
      "rebuild": 0.003544634626865672, "eos": 0.0037894805970149254,
      "advance": 0.003731166567164179}),
    (("wcsph", 3, 739024, 676500, 93310, 2, {"with_self": 1.9e8}),
     {"density": 0.07089552238805971, "force": 0.1701492537313433,
      "rebuild": 0.012409542089552238, "eos": 0.014339271641791045,
      "advance": 0.013894700895522388}),
    (("legacy", 2, 6304, 6300, 12544, 1, {"fluid": 1.5e5, "live": 1.6e5}),
     {"density": 6.766925373134329e-05, "force": 0.0001354137313432836,
      "rebuild": 0.00019563104477611943, "eos": 0.00011478925373134328,
      "advance": 8.278925373134329e-05}),
    (("legacy", 3, 195304, 195300, 468750, 1, {"fluid": 4.1e7, "live": 4.2e7}),
     {"density": 0.014686567164179104, "force": 0.03322388059701493,
      "rebuild": 0.007089269253731344, "eos": 0.0037894805970149254,
      "advance": 0.003731166567164179}),
]


@pytest.mark.parametrize("args,phases", PINNED)
def test_step_bound_is_pinned(args, phases):
    assert work.step_bound_ms(*args) == phases


def test_pair_count_with_boundary_rows_on_the_grid():
    """The tank of boundary rows, whose lattice lies on the faces of the
    cells: every fluid row's pairs with fluid and boundary rows counted."""
    from benchmark import inputs
    from benchmark.tests import tiny

    scene = tiny.TINY_SCENES["tiny_3d_walls"][1]
    s0 = inputs.start_state(scene, 0.01, 2 ** 31 + 5)
    cfg = scene["configuration"]
    got = work.count_pairs(torch.from_numpy(s0["x"]), torch.from_numpy(s0["material"]), 0.04,
                           cfg["domainStart"], cfg["domainEnd"])
    assert got == _brute(s0["x"], s0["material"], 0.04)
    assert got["live"] > got["fluid"]  # boundary neighbours are counted


def test_step_bound_takes_every_row(monkeypatch):
    """``harness.step_bound`` hands the work every row of a state with
    boundary rows, its fluid rows apart, and the mean of the pair counts."""
    from benchmark import harness, inputs
    from benchmark.tests import tiny

    scene = tiny.TINY_SCENES["tiny_3d_walls"][1]
    states = [inputs.start_state(scene, 0.01, s) for s in (1, 2)]
    cell = types.SimpleNamespace(scene=scene, config={"solver": "wcsph", "resort_every": 2},
                                 traffic={"resort_every": None})
    seen = {}

    def bound(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return {"all": 1.0}

    monkeypatch.setattr(work, "step_bound_ms", bound)
    assert harness.step_bound(cell, states) == 1.0
    solver, dim, rows, fluid, cells, resort, pairs = seen["args"]
    n = int(states[0]["num_active"])
    assert (solver, dim, rows, resort) == ("wcsph", 3, n, 2) and seen["kw"] == {"bodies": 0}
    assert fluid == int((states[0]["material"] == 1).sum()) < n
    assert cells == work.grid_cells([0.0] * 3, [0.5] * 3, 0.04)
    mean = {k: sum(_brute(s["x"], s["material"], 0.04)[k] for s in states) / 2 for k in pairs}
    assert pairs == pytest.approx(mean, rel=1e-12)
