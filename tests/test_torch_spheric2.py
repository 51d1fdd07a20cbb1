"""SPHERIC validation test 2 (Kleefsman et al. 2005, J. Comput. Phys.
206:363-393), ``scenes/spheric2_3d.json``: MARIN's dam break against a box
in a walled tank, on the port's normal path.

- The scene: 676,500 fluid rows, each block's rows as the benchmark's
  configuration (``benchmark/configs/spheric2.json``) states them; no two
  blocks overlap; the water inside the tank, outside the box and at least
  the radius from every boundary row; the clamp box outside every wall;
  the benchmark's frozen copy equal to it byte for byte; ``make_solver``
  gives a static-boundary ``WCSPH``.
- :func:`tank` writes the scene from the test's geometry at a scale, by
  the rules the scene's blocks follow; at scale 1 it gives the file's
  blocks.
- The port on the CPU against the plain float64 reference
  (``benchmark/reference/v2.py``: plain torch, no port kernel) on the
  tank at 1/8 of its lengths and the same radius (2,668 rows; 1/4, 15,000
  rows, takes about a minute on two threads), 20 steps at R = 2 from a
  seeded start; the same with Akinci's boundary viscosity left out
  (``boundary_sigma=0``) fails the tolerances.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import types

import numpy as np
import pytest
import torch

import tisph_tpu_torch as tt
from benchmark import check, inputs
from benchmark.program import to_host

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENE = REPO / "scenes" / "spheric2_3d.json"
CONFIG = json.loads((REPO / "benchmark" / "configs" / "spheric2.json").read_text())
RADIUS = 0.01
D = 2 * RADIUS  # the boundary rows' spacing

# the comparison's tolerances, over the fluid rows after 20 steps at R = 2
# from the same input (``benchmark.check``'s numbers):
# - dx_gap, dv_gap: the port's float32 pair sums, in another order than the
#   reference's float64 ones, part by rounding, and the pairs near h carry
#   that into the next step; read 4.7e-3 and 2.7e-3 (8.2e-3 and 7.5e-3 at
#   1/4 of the lengths), and the boundary viscosity left out reads 152 and 896
TOL_DX_DV = 0.05
# - rho_gap, p_gap: float32 sums of about 270 terms, each within a few
#   float32 steps (6e-8) of its own, over 20 steps; read 4.9e-6 and 4.3e-6
#   (2.6e-5 and 1.1e-5 at 1/4), the boundary viscosity left out 0.35 and 0.69
TOL_RHO_P = 1e-4
# - lost: every row found by its tag, each boundary row in place bitwise
#   and its Akinci volume within check.VOLUME_RTOL (1e-4) of the reference's V_b


def _span(first: float, last: float) -> tuple[float, float]:
    """A block axis of layers ``first + k D`` up to ``last``, its end half a
    spacing past the last layer (so ``np.arange`` samples no extra one)."""
    n = math.floor((last - first) / D + 1e-9) + 1
    return first, first + (n - 1) * D + D / 2


def tank(s: float) -> dict:
    """SPHERIC 2 at ``s`` times its lengths: a tank 3.22 x 1 x 1 (x along
    it, y up), water 1.228 x 0.55 against the x = 3.22 wall, a box 0.161 x
    0.161 x 0.403 from x = 0.6635 on the floor, centred in z.  Walls: two
    boundary layers at the diameter, half and one and a half diameters
    behind each face, the floor under the walls' footprint, the x walls
    with the corner columns, up to the tank's height, no roof."""
    L, H, W = 3.22 * s, 1.0 * s, 1.0 * s
    low = _span(-1.5 * D, -0.5 * D)

    def high(face):
        return _span(face + 0.5 * D, face + 1.5 * D)

    def inner(face):
        return _span(0.5 * D, face - 0.5 * D)

    def whole(face):
        return _span(-1.5 * D, face + 1.5 * D)

    walls = [(whole(L), low, whole(W)),
             (low, inner(H), whole(W)), (high(L), inner(H), whole(W)),
             (inner(L), inner(H), low), (inner(L), inner(H), high(W))]
    blocks = [{"start": [a[0] for a in b], "end": [a[1] for a in b], "density": 1000.0,
               "color": [160, 160, 160]} for b in walls]
    x0, z0 = 0.6635 * s, (W - 0.403 * s) / 2
    blocks.append({"start": [x0, 0.0, z0], "end": [x0 + 0.161 * s, 0.161 * s, z0 + 0.403 * s],
                   "density": 1000.0, "color": [120, 80, 60]})
    return {
        "configuration": {"dim": 3, "domainStart": [-0.1, -0.1, -0.1],
                          "domainEnd": [L + 0.12, H + 0.3, W + 0.1],
                          "particleRadius": RADIUS, "density0": 1000,
                          "gravitation": [0.0, -9.81, 0.0], "c_s": 88.5},
        "rigidBodies": [],
        "fluidBlocks": [{"start": [L - 1.228 * s, 0.0, 0.0], "end": [L, 0.55 * s, W],
                         "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
                         "color": [50, 100, 200]}],
        "boundaryBlocks": blocks,
    }


@pytest.fixture(scope="module")
def built():
    scene = tt.load_scene(SCENE)
    return scene, tt.build_state(scene, device="cpu")


def _extents(state, block: int) -> tuple[np.ndarray, np.ndarray]:
    """The least and largest coordinates of one block's rows (``build_state``
    gives block k the tag k: boundary blocks first, then the water)."""
    x = state.x[state.object_id == block].numpy().astype(np.float64)
    return x.min(0), x.max(0)


def test_rows_by_block(built):
    scene, st = built
    counts = list(CONFIG["rows_by_block"].values())
    blocks = len(scene.boundary_blocks)
    assert [int((st.object_id == k).sum()) for k in range(blocks + 1)] == counts[1:] + counts[:1]
    assert int(st.fluid_mask.sum()) == CONFIG["fluid_particles"] == 676_500
    assert int(st.boundary_mask.sum()) == CONFIG["boundary_particles"] == sum(counts[1:])
    assert st.num_active == CONFIG["rows"]


def test_blocks_apart_and_the_water_in_the_tank(built):
    """No two blocks' boxes overlap; the water lies in the tank's interior,
    outside the box, and each block of boundary rows lies at least the
    radius from it; the clamp box [start + h, end - h] holds every wall."""
    scene, st = built
    boxes = [(np.array(b.start), np.array(b.end)) for b in scene.boundary_blocks]
    boxes += [(np.array(b.start), np.array(b.end)) for b in scene.fluid_blocks]
    for i in range(len(boxes)):
        for j in range(i):
            (a0, a1), (b0, b1) = boxes[i], boxes[j]
            assert (np.minimum(a1, b1) <= np.maximum(a0, b0)).any(), (i, j)
    water = len(scene.boundary_blocks)
    lo, hi = _extents(st, water)
    assert (lo >= 0).all() and (hi < [3.22, 1.0, 1.0]).all()
    assert lo[0] >= boxes[water - 1][1][0]  # beyond the box
    for k in range(water):
        b0, b1 = _extents(st, k)
        gap = np.maximum(0.0, np.maximum(b0 - hi, lo - b1))
        assert np.sqrt((gap ** 2).sum()) >= RADIUS - 1e-6, k
    h = scene.support_length
    clamp_lo = np.array(scene.domain_start) + h
    clamp_hi = np.array(scene.domain_end) - h
    walls = st.x[st.boundary_mask].numpy()
    assert (walls.min(0) > clamp_lo).all() and (walls.max(0) < clamp_hi).all()
    assert clamp_hi[1] >= 1.0 + 0.2  # room for the splash above the tank


def test_the_benchmarks_copy_is_the_scene():
    frozen = REPO / "benchmark" / "configs" / CONFIG["scene"]
    assert frozen.read_bytes() == SCENE.read_bytes()


def test_make_solver_gives_a_static_boundary_wcsph(built):
    scene, st = built
    solver, bound, rigid = tt.make_solver(scene, st, device="cpu", resort_every=2)
    assert type(solver) is tt.WCSPH and solver.boundary_mode == "static" and rigid is None
    wall = bound.boundary_mask
    assert (bound.volume[wall] != st.volume[wall]).all()  # Akinci's volumes, set at bind
    assert torch.equal(bound.volume[~wall], st.volume[~wall])


def test_tank_at_scale_one_is_the_scene():
    raw = json.loads(SCENE.read_text())
    made = tank(1.0)
    pairs = [(made["configuration"], raw["configuration"])] + [
        pair for key in ("fluidBlocks", "boundaryBlocks")
        for pair in zip(made[key], raw[key], strict=True)]
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            assert np.allclose(a[k], b[k], rtol=0, atol=1e-12), (k, a[k], b[k])
    assert made["rigidBodies"] == raw["rigidBodies"] == []


@pytest.fixture(scope="module")
def eighth():
    """The tank at 1/8 of its lengths, S0 from a seed, the plain float64
    reference's 20 steps at R = 2 from it."""
    raw = tank(0.125)
    cell = types.SimpleNamespace(scene=raw, config={"compat": "reference", "reference": "v2"},
                                 root=REPO / "benchmark")
    s0 = inputs.start_state(raw, 0.01, 2 ** 31 + 23)
    ref = check.reference_steps(cell, s0, 20, 2, torch.device("cpu"))
    return cell, s0, ref


def _port(cell, s0, **params) -> dict:
    scene = tt.scene_from_dict(cell.scene)
    p = dataclasses.replace(tt.SolverParams.from_scene(scene, "reference"), **params)
    solver = tt.WCSPH(scene, device="cpu", resort_every=2, params=p)
    st = tt.build_state(scene, device="cpu")
    n = st.num_active
    x, tags = st.x.clone(), st.object_id.clone()
    x[:n] = torch.from_numpy(s0["x"])
    tags[:n] = torch.from_numpy(s0["object_id"])
    out = solver.rollout(solver.bind(dataclasses.replace(st, x=x, object_id=tags)), 20)
    return to_host(out)


def _within(nums: dict) -> bool:
    return (max(nums["dx_gap"], nums["dv_gap"]) <= TOL_DX_DV
            and max(nums["rho_gap"], nums["p_gap"]) <= TOL_RHO_P and nums["lost"] == 0)


def test_port_matches_the_reference_on_the_small_tank(eighth):
    cell, s0, ref = eighth
    assert (s0["material"] == 0).sum() > 1000 and (s0["material"] == 1).sum() > 1000
    nums = check.compare(cell, s0, _port(cell, s0), ref)
    assert _within(nums), nums
    assert np.isfinite(ref["x"].numpy()).all()


def test_boundary_viscosity_left_out_fails(eighth):
    cell, s0, ref = eighth
    nums = check.compare(cell, s0, _port(cell, s0, boundary_sigma=0.0), ref)
    assert not _within(nums), nums
