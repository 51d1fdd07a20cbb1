"""Port linear-layout sweep parity: the plain density_sweep_linear and
force_sweep_linear (ops.neighbors) against tisph_tpu's linear TPU kernel in
interpret mode (ops/pallas/sweeps.py density_sweep and force_sweep, block
128, tile 128, capacity <= 2048) on the same sorted state: 2D and 3D fluid,
a 3D scene with boundary blocks, the evolved clustered state of
tests/test_pallas.py::test_linear_density_matches_bruteforce_mid_collapse,
and JAX's i side that is a row slice of the j array (``ipack``, the
sharded caller's), which computes those rows of the port's full sweep.
The plain linear and seg sweeps agree on each state.  On the same states
the invariant the CUDA kernel indexes by: every stencil run of a fluid row
lies inside its block's window of that stencil row, and the runs hold
exactly the linear layout's candidates.

Tolerances, the JAX suite's for the same sums taken in another order:
density rtol 2e-5, force scaled by its largest component atol 5e-6.  The
TPU kernel clips windows at ``window_cap``: every case asserts that
block_meta's ``need`` fits, or a clipped reference would pass silently.
The CUDA kernel runs on a card only (the `cuda` tests)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tisph_tpu as tt
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops import forces as jF
from tisph_tpu.ops import grid as jgrid
from tisph_tpu.ops.pallas import sweeps as ps

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import pad_state_capacity
from tisph_tpu_torch.ops import forces as F
from tisph_tpu_torch.ops import grid, neighbors
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.utils import profiling

torch.set_num_threads(2)

RTOL, FORCE_ATOL = 2e-5, 5e-6
BLOCK, TILE = 128, 128


def _raw(dim, radius=0.04, boundary=False, spacing=None):
    """test_pallas._scene(dim, radius), or with boundary blocks its
    test_linear_sweeps_with_boundary_particles scene; ``spacing``: the
    fluid lattice's, the radius by default."""
    raw = {
        "configuration": {
            "dim": dim, "domainStart": [0.0] * dim, "domainEnd": [1.0] * dim,
            "particleRadius": radius, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0][:dim], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.15] * dim, "end": [0.55] * dim,
                         "velocity": [0.2, -1.0, 0.5][:dim], "density": 1000.0}],
    }
    if boundary:
        raw["boundaryBlocks"] = [{"start": [0.3, 0.05, 0.3], "end": [0.7, 0.2, 0.7]}]
        raw["fluidBlocks"][0] |= {"start": [0.25, 0.22, 0.25], "end": [0.6, 0.55, 0.6]}
    if spacing is not None:
        raw["fluidBlocks"][0]["spacing"] = spacing
    return raw


def _state(raw, cap, evolve=0):
    """The bound JAX state at capacity ``cap``, after ``evolve`` steps of
    its default CPU (blocked) solver; the solver's spec and params."""
    scene = tt.scene_from_dict(raw)
    solver = tt.WCSPH(scene)
    state = solver.bind(jax_pad(tt.build_state(scene), cap))
    for _ in range(evolve):
        state = solver.step(state)
    return state, solver.spec, solver.params


def _port_sorted(st_j, spec_j):
    """The sorted JAX state ``st_j`` as a port state with its ids, CSR
    bounds and grid spec."""
    n = st_j.capacity
    port = pad_state_capacity(pt.state_from_host(jax_to_host(st_j), "cpu"), n)
    spec = grid.make_grid_spec(spec_j.dim, spec_j.domain_start, spec_j.domain_end,
                               spec_j.cell_size)
    assert (spec.res, spec.strides) == (spec_j.res, spec_j.strides)
    st, ids, perm = grid.sort_state_by_cell(port, spec)
    assert torch.equal(perm, torch.arange(n))  # already sorted
    return st, ids, grid.csr_bounds(ids, spec), spec


def _compare(raw, state, spec_j, params_j, window, i_off=0, n_i=None):
    """Plain linear sweeps vs the linear TPU kernel on ``state`` sorted, on
    the i rows [i_off, i_off + n_i) (an ``ipack`` row slice on the JAX
    side, the port sweeping all rows); plain linear vs plain seg."""
    st_j, ids_j, _ = jgrid.sort_state_by_cell(state, spec_j)
    n = st_j.capacity
    n_i = n - i_off if n_i is None else n_i
    assert n % BLOCK == 0 and n_i % BLOCK == 0  # the TPU kernel's grid
    pack = ps.pack_state(st_j.x, st_j.v, st_j.density, st_j.pressure, st_j.mass,
                         st_j.volume, st_j.material, ids_j, params_j)
    coords = jgrid.cell_coords(st_j.x, spec_j)
    jargs = (spec_j, params_j, BLOCK, window)
    kw = dict(tile=TILE, interpret=True, fast_math=False)
    meta, need = ps.block_meta(ids_j, coords, spec_j, BLOCK, window)
    assert int(need) <= window
    sl = slice(i_off, i_off + n_i)
    meta_i, need_i = ps.block_meta(ids_j, coords[sl], spec_j, BLOCK, window,
                                   ids_i=ids_j[sl])
    assert int(need_i) <= window
    sliced = (i_off, n_i) != (0, n)

    st, ids, bounds, spec = _port_sorted(st_j, spec_j)
    params = pt.SolverParams.from_scene(pt.scene_from_dict(raw))
    fl = st.fluid_mask
    flm = fl.to(torch.float32) * st.mass
    pos = neighbors.pack4(st.x, flm + st.boundary_mask.to(torch.float32)
                          * (params.density0 * st.volume))
    fluid_i = fl.numpy()[sl]
    assert fluid_i.any()

    # density
    rho_j = ps.density_sweep(pack, meta, *jargs, **kw)
    rho_ji = np.asarray(ps.density_sweep(pack, meta_i, *jargs, **dict(kw, ipack=pack[:, sl]))
                        if sliced else rho_j)
    rho = neighbors.density_sweep_linear(pos, ids, bounds, st.material, spec, params)
    seg = neighbors.density_sweep(pos, ids, bounds, st.material, spec, params)
    np.testing.assert_allclose(rho.numpy(), seg.numpy(), rtol=1e-6)
    rho = rho[sl].numpy()
    np.testing.assert_allclose(rho[fluid_i], rho_ji[fluid_i], rtol=RTOL)
    assert (rho[~fluid_i] == 0).all()

    # force, both sides fed the JAX density through the EOS
    rho_f, p_j = jF.compute_pressures(jnp.where(st_j.fluid_mask, rho_j, st_j.density), params_j)
    pack = ps.repack_eos(pack, rho_f, p_j)
    dv_j = np.asarray(ps.force_sweep(pack, meta_i, *jargs,
                                     **(dict(kw, ipack=pack[:, sl]) if sliced else kw)))
    rho_t, p_t = torch.tensor(np.asarray(rho_f)), torch.tensor(np.asarray(p_j))
    vel = neighbors.pack4(st.v, rho_t)
    aux = neighbors.pack_aux(p_t / torch.clamp(rho_t * rho_t, min=1e-12), flm, st.mass)
    dv = neighbors.force_sweep_linear(pos, vel, aux, ids, bounds, st.material, spec, params)
    seg = neighbors.force_sweep(pos, vel, aux, ids, bounds, st.material, spec, params)
    dv, seg = dv.numpy(), seg.numpy()
    scale = np.abs(dv_j[fluid_i]).max()
    np.testing.assert_allclose(dv / scale, seg / scale, rtol=0, atol=1e-7)
    dv = dv[sl]
    np.testing.assert_allclose(dv[fluid_i] / scale, dv_j[fluid_i] / scale, atol=FORCE_ATOL)
    assert (dv[~fluid_i] == 0).all()
    return st


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_linear_sweeps_match_linear_kernel(dim):
    raw = _raw(dim)
    state, spec, params = _state(raw, 2048 if dim == 3 else 256)
    _compare(raw, state, spec, params, window=1152 if dim == 3 else 256)


def test_plain_linear_sweeps_match_linear_kernel_with_boundary():
    raw = _raw(3, boundary=True)
    state, spec, params = _state(raw, 2048)
    st = _compare(raw, state, spec, params, window=1152)
    assert st.boundary_mask.any()


def test_plain_linear_sweeps_match_linear_kernel_mid_collapse():
    """test_linear_density_matches_bruteforce_mid_collapse's evolved,
    clustered state (12 steps; here of the JAX CPU solver): blocks whose
    windows straddle dense rows."""
    raw = _raw(3, radius=0.045)
    state, spec, params = _state(raw, 1536, evolve=12)
    _compare(raw, state, spec, params, window=1536)


def test_plain_linear_sweeps_match_linear_kernel_row_slice():
    """JAX's i side of rows [165, 677) of the j array (the sharded
    caller's ``ipack``, blocks unaligned to the j array's) against those
    rows of the port's sweep of all rows."""
    raw = _raw(3)
    state, spec, params = _state(raw, 2048)
    _compare(raw, state, spec, params, window=1152, i_off=165, n_i=512)


@pytest.mark.parametrize("case", ["2d", "3d", "3d_boundary", "3d_mid_collapse", "3d_dense"])
def test_stencil_runs_lie_inside_block_windows(case):
    """What the CUDA kernel indexes by: the candidates of a fluid row in a
    stencil row are its contiguous run of the sorted array
    (``grid.stencil_runs``), and the run lies inside the window of the
    row's block (``grid.block_window_bounds``), so the kernel reads it out
    of the staged window with no id test.  Every state has an inactive
    tail; the dense lattice's windows are several thousand j long."""
    raw, cap, evolve = {
        "2d": (_raw(2), 256, 0),
        "3d": (_raw(3), 2048, 0),
        "3d_boundary": (_raw(3, boundary=True), 2048, 0),
        "3d_mid_collapse": (_raw(3, radius=0.045), 1536, 12),
        "3d_dense": (_raw(3, spacing=0.0252), 4224, 0),
    }[case]
    state, spec_j, _ = _state(raw, cap, evolve=evolve)
    st, ids, bounds, spec = _port_sorted(jgrid.sort_state_by_cell(state, spec_j)[0], spec_j)
    assert not st.active_mask.all()
    assert st.boundary_mask.any() == (case == "3d_boundary")
    rows = torch.nonzero(st.fluid_mask).squeeze(1)
    coords = grid.coords_from_ids(ids, spec)
    runs = grid.stencil_runs(coords[rows], bounds, spec)
    run_lo, run_hi = runs[..., 0], runs[..., 1]
    w_lo, w_hi = grid.block_window_bounds(ids, coords, spec, BLOCK, bounds=bounds)
    blk = torch.div(rows, BLOCK, rounding_mode="floor")
    inside = (w_lo[blk] <= run_lo) & (run_hi <= w_hi[blk])
    assert (inside | (run_hi <= run_lo)).all()
    assert (run_hi > run_lo).any(dim=1).all()  # every fluid row has its own cell's run
    n_cand = sum(i.numel() for i, _ in neighbors.candidates(ids, bounds, rows, spec,
                                                            layout="linear"))
    assert int((run_hi - run_lo).clamp(min=0).sum()) == n_cand
    if case == "3d_dense":
        assert int((w_hi - w_lo).clamp(min=0).sum(dim=1).max()) > 4096


def test_linear_wrappers_take_plain_versions_on_cpu():
    raw = _raw(2, boundary=False)
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cpu", layout="linear")
    st, ids, _ = grid.sort_state_by_cell(solver.bind(pt.build_state(scene, device="cpu")),
                                         solver.spec)
    spec, params = solver.spec, solver.params
    bounds = grid.csr_bounds(ids, spec)
    flm = st.fluid_mask.to(torch.float32) * st.mass
    pos = neighbors.pack4(st.x, flm)
    vel = neighbors.pack4(st.v, st.density)
    aux = neighbors.pack_aux(F.compute_pressures(st.density, params)[1] / 1e6, flm, st.mass)
    before = profiling.launch_counters()
    assert torch.equal(
        cuda_sweeps.density_sweep_linear(pos, ids, bounds, st.material, spec, params),
        neighbors.density_sweep_linear(pos, ids, bounds, st.material, spec, params))
    assert torch.equal(
        cuda_sweeps.force_sweep_linear(pos, vel, aux, ids, bounds, st.material, spec, params),
        neighbors.force_sweep_linear(pos, vel, aux, ids, bounds, st.material, spec, params))
    assert profiling.launch_counters() == before
    with pytest.raises(ValueError):
        cuda_sweeps.density_sweep_linear(pos, ids, bounds, st.material, spec, params,
                                         windows=torch.zeros((1, 3, 2), dtype=torch.int32))


def _cuda_inputs(raw):
    """A bound state on the card, sorted, with the packs of one substep
    (density from the plain version)."""
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cuda", layout="linear")
    state = solver.bind(pt.build_state(scene, device="cuda"))
    gen = torch.Generator(device="cpu").manual_seed(5)
    state = dataclasses.replace(state, v=state.v + torch.randn(
        state.v.shape, generator=gen).to("cuda"))
    spec, params = solver.spec, solver.params
    st, ids, _ = grid.sort_state_by_cell(state, spec)
    bounds = grid.csr_bounds(ids, spec)
    flm = st.fluid_mask.to(torch.float32) * st.mass
    pos = neighbors.pack4(st.x, flm + st.boundary_mask.to(torch.float32)
                          * (params.density0 * st.volume))
    rho = neighbors.density_sweep(pos, ids, bounds, st.material, spec, params)
    rho, p = F.compute_pressures(torch.where(st.fluid_mask, rho, st.density), params)
    vel = neighbors.pack4(st.v, rho)
    aux = neighbors.pack_aux(p / torch.clamp(rho * rho, min=1e-12), flm, st.mass)
    return st, ids, bounds, spec, params, pos, vel, aux


@pytest.mark.cuda
@pytest.mark.parametrize("dim,boundary,spacing", [(2, False, None), (3, False, None),
                                                  (3, True, None), (3, False, 0.0252)])
def test_linear_kernel_matches_plain_on_cuda(dim, boundary, spacing):
    """The last case is a lattice 4 times denser than radius spacing: its
    blocks' windows, several thousand j in all, fill the kernel's
    shared-memory chunk many times over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the linear sweep kernel has no CPU mode")
    st, ids, bounds, spec, params, pos, vel, aux = _cuda_inputs(
        _raw(dim, boundary=boundary, spacing=spacing))
    fl = st.fluid_mask
    mat = st.material
    want_rho = neighbors.density_sweep_linear(pos, ids, bounds, mat, spec, params)
    want_dv = neighbors.force_sweep_linear(pos, vel, aux, ids, bounds, mat, spec, params)
    windows = torch.empty((-(-ids.shape[0] // 128), spec.num_rows, 2), dtype=torch.int32,
                          device="cuda")
    for fast, atol in ((False, FORCE_ATOL), (True, 2 * FORCE_ATOL)):
        rho = cuda_sweeps.density_sweep_linear(pos, ids, bounds, mat, spec, params, fast,
                                               windows=windows)
        dv = cuda_sweeps.force_sweep_linear(pos, vel, aux, ids, bounds, mat, spec, params,
                                            fast)
        torch.testing.assert_close(rho[fl], want_rho[fl], rtol=RTOL, atol=0)
        assert torch.equal(rho[~fl], torch.zeros_like(rho[~fl]))
        scale = want_dv[fl].abs().max()
        torch.testing.assert_close(dv[fl] / scale, want_dv[fl] / scale, rtol=0, atol=atol)
        assert torch.equal(dv[~fl], torch.zeros_like(dv[~fl]))
        # the same function as the seg kernel; its terms in the same order
        # where that runs one thread per row (large launches only)
        seg = cuda_sweeps.density_sweep(pos, ids, bounds, mat, spec, params, fast)
        if cuda_sweeps.launch_shape("density", ids.shape[0])[0] == 1:
            assert torch.equal(rho, seg)
        torch.testing.assert_close(rho[fl], seg[fl], rtol=RTOL, atol=0)
    lo, hi = grid.block_window_bounds(ids, grid.coords_from_ids(ids, spec), spec, 128)
    assert torch.equal(windows, torch.stack([lo, hi], dim=-1))
    if spacing is not None:
        assert int((hi - lo).clamp(min=0).sum(dim=1).max()) > 4096
