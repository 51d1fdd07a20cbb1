"""The legacy kernel's launch rule and the legacy solver's graph plumbing,
on the CPU.

- ``legacy_launch_shape`` (``ops/cuda/legacy.py``): how many threads of
  ``csrc/legacy.cu`` share a row is a rule of the row count (by dim), a
  built power of two that does not grow with the rows, and the CTAs
  cover every row;
- on a CPU tensor the wrappers take the plain version, and a launch at a
  lane count of its own (``_launch``, the card's checks) raises;
- ``WCSPHLegacy`` through ``GroupRunner(capture=False)`` (the graph
  path's copy in, group on the static buffers, write back and copy out,
  with a direct call in place of each replay) is bitwise its eager loop
  in ``x``, ``v``, ``density``, ``pressure`` and ``volume``: demo_2d with
  static volumes, and the 3D dam break (a boundary block) with per-step
  volumes.
"""

import pytest
import torch

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.graphs import GroupRunner
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.ops.cuda import legacy as cuda_legacy
from tisph_tpu_torch.ops.grid import csr_bounds, sort_state_by_cell
from tisph_tpu_torch.ops.eos import tait_pressure
from test_torch_legacy_sweeps import DAM_3D

torch.set_num_threads(2)

ROWS = (1, 127, 128, 129, 4_496, 6_304, 12_600, 25_200, 35_999, 36_000, 50_224, 71_999,
        72_000, 100_800, 195_304, 1_000_000, 2**31 - 2)


@pytest.mark.parametrize("dim", [2, 3])
def test_legacy_launch_shape_is_a_rule_of_the_row_count(dim):
    """A built power of two of lanes a row, never more as the rows grow;
    the CTAs of 128 threads cover every row and no more."""
    last = None
    for n in ROWS:
        lanes, ctas = cuda_legacy.legacy_launch_shape(dim, n)
        assert lanes in cuda_legacy.LANES and lanes & (lanes - 1) == 0
        assert (ctas - 1) * (128 // lanes) < n <= ctas * (128 // lanes)
        assert last is None or lanes <= last
        assert cuda_legacy.legacy_launch_shape(dim, n) == (lanes, ctas)
        last = lanes
    # the timed brackets (PERF.md section 6): 16 lanes won on the first
    # row count of each pair, 4 on the second
    won16, won4 = {2: (25_200, 50_400), 3: (50_224, 100_800)}[dim]
    assert cuda_legacy.legacy_launch_shape(dim, won16)[0] == 16
    assert cuda_legacy.legacy_launch_shape(dim, won4)[0] == 4


def test_cpu_wrappers_take_the_plain_version_at_any_lanes():
    scene = pt.scene_from_dict(DAM_3D)
    solver = pt.WCSPHLegacy(scene, device="cpu")
    spec, params = solver.spec, solver.params
    st, ids, _ = sort_state_by_cell(solver.bind(pt.build_state(scene, device="cpu")), spec)
    tail = (ids, csr_bounds(ids, spec), st.material, spec, params)
    pos = neighbors.legacy_pos(st)
    rho = neighbors.legacy_density_sweep(pos, *tail)
    rho, p = tait_pressure(torch.where(st.fluid_mask, rho, st.density), params.density0,
                           params.stiffness, params.exponent)
    vel, aux = neighbors.legacy_force_packs(st, rho, p)
    want = (neighbors.legacy_density_sweep(pos, *tail),
            neighbors.legacy_force_sweep(pos, vel, aux, *tail))
    assert torch.equal(cuda_legacy.legacy_density_sweep(pos, *tail), want[0])
    assert torch.equal(cuda_legacy.legacy_force_sweep(pos, vel, aux, *tail), want[1])
    for lanes in cuda_legacy.LANES:  # no plain fallback from a launch of its own
        for mode, packs in (("density", (pos, None, None)), ("force", (pos, vel, aux))):
            with pytest.raises(ValueError, match="unsupported device cpu"):
                cuda_legacy._launch(mode, lanes, *packs, *tail)


@pytest.mark.parametrize("boundary_mode", ["static", "per_step"])
def test_graph_plumbing_equals_eager_loop(boundary_mode):
    """5 steps through ``GroupRunner(capture=False)`` against the eager
    loop from the same bound start, bitwise in every field the step
    writes."""
    per_step = boundary_mode == "per_step"
    scene = pt.scene_from_dict(DAM_3D) if per_step else pt.load_scene("scenes/demo_2d.json")
    solver = pt.WCSPHLegacy(scene, device="cpu", boundary_mode=boundary_mode)
    start = solver.bind(pt.build_state(scene, device="cpu"))
    want = solver.rollout(start, 5)
    assert not solver.graphs and solver._runner is None
    solver.graphs = True
    solver._runner = GroupRunner(solver, capture=False)
    got = solver.rollout(start, 5)
    assert solver._runner._base is not None  # the runner ran the groups
    assert not torch.equal(got.x, start.x)
    for k in ("x", "v", "density", "pressure", "volume"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
