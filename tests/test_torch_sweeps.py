"""Port sweep parity: the plain density, force, bvol, force_react and
reaction sweeps (ops.neighbors) against tisph_tpu's seg TPU kernel in
interpret mode (density_sweep_seg, force_sweep_seg, bvol_sweep_seg,
force_react_sweep_seg, reaction_sweep_seg) on the same sorted state, in 2D
and 3D, with and without boundary particles; the coupling modes on a
moving boundary body inside the fluid, with per-step volumes.  Beside the
plain lattices, the states the CUDA kernel's walk is sensitive to: a
lattice at 0.63 of the radius spacing (a cell dense enough to fill a
thread's queue of pairs many times), a lone fluid particle (its self pair
only), and a capacity that is no multiple of 128 with an inactive tail.

Tolerances, the JAX suite's for the same sums taken in another order:
density and bvol rtol 2e-5 (tests/test_seg.py:117), force scaled by its
largest component atol 5e-6 (tests/test_pallas.py:117, test_seg.py:223),
and the reaction scaled by its largest component at the same bound.  The
CUDA kernel runs on a card only (the `cuda` tests)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops import forces as jF
from tisph_tpu.ops import grid as jgrid
from tisph_tpu.ops.neighbors import SweepConfig
from tisph_tpu.ops.pallas import sweeps as ps

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import pad_state_capacity
from tisph_tpu_torch.ops import forces as F
from tisph_tpu_torch.ops import grid, neighbors
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.utils import profiling

torch.set_num_threads(2)

RTOL, FORCE_ATOL = 2e-5, 5e-6


def _ragged(n):
    """A capacity past ``n`` rows that is no multiple of 128: the last CTA
    of the kernel is ragged and a warp mixes live rows with the tail."""
    cap = n + 37
    return cap + 1 if cap % 128 == 0 else cap


# chip_smoke.py's MANY_CHUNKS: 20^3 fluid particles at 0.63 of the radius
# spacing, up to 343 to a cell (card only: too many pairs for interpret mode)
MANY = {
    "configuration": {
        "dim": 3, "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.0, 1.0, 1.0],
        "particleRadius": 0.01, "density0": 1000,
        "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
    },
    "fluidBlocks": [{"start": [0.4, 0.4, 0.4], "end": [0.52, 0.52, 0.52],
                     "velocity": [0.5, -1.0, 0.25], "density": 1000.0,
                     "color": [50, 100, 200], "spacing": 0.0063}],
}


def _raw(dim, boundary, state=None):
    """``state``: None, "dense" (a small block at 0.63 of the radius
    spacing: every row has 144 (2D) or 216 (3D) candidates, most of them
    inside h), "lone" (a second block of one particle far from the first),
    "ragged" (the plain scene; the capacity is padded) or "many" (MANY)."""
    if state == "many":
        return MANY
    raw = {
        "configuration": {
            "dim": dim, "domainStart": [0.0] * dim, "domainEnd": [1.0] * dim,
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0][:dim], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.15] * dim, "end": [0.55] * dim,
                         "velocity": [0.2, -1.0, 0.5][:dim], "density": 1000.0}],
    }
    if boundary:
        raw["boundaryBlocks"] = [{"start": [0.5, 0.1, 0.3][:dim],
                                  "end": [0.75, 0.35, 0.6][:dim]}]
    if state == "dense":
        raw["fluidBlocks"][0] |= {"end": [0.45 if dim == 2 else 0.3] * dim, "spacing": 0.0252}
    elif state == "lone":
        raw["fluidBlocks"].append({"start": [0.8] * dim, "end": [0.81] * dim,
                                   "velocity": [0.0] * dim, "density": 1000.0})
    return raw


def _setup(dim, boundary, tag=None):
    """JAX seg inputs and the same sorted state in the port; ``tag``:
    _raw's ``state``."""
    raw = _raw(dim, boundary, tag)
    scene = tt.scene_from_dict(raw)
    solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
        layout="seg", pad_capacity=8192, fast_math=False))
    state = solver.bind(tt.build_state(scene))
    spec_j, params_j, cfg = solver.spec, solver.params, solver.sweep_cfg
    st_j, ids_j, _ = jgrid.sort_state_by_cell(state, spec_j)
    plan = jgrid.seg_plan(ids_j, spec_j, cfg.block_size, cfg.pad_capacity // cfg.block_size)
    meta, need = ps.seg_block_meta(plan, ids_j, spec_j, cfg.block_size, cfg.window_cap)
    if tag is not None:
        assert int(need) <= cfg.window_cap  # or the reference clips its windows
    pack = ps.pack_state(st_j.x, st_j.v, st_j.density, st_j.pressure, st_j.mass,
                         st_j.volume, st_j.material, ids_j, params_j)
    jax_args = (meta, spec_j, params_j, cfg.block_size, cfg.window_cap)
    kw = dict(tile=cfg.tile, interpret=True)

    port = pt.state_from_host(jax_to_host(st_j), "cpu")
    if tag == "ragged":  # the JAX side pads to its own block multiple
        port = pad_state_capacity(port, _ragged(port.capacity))
    spec = grid.make_grid_spec(dim, scene.domain_start, scene.domain_end, scene.support_length)
    params = pt.SolverParams.from_scene(pt.scene_from_dict(raw))
    st, ids, perm = grid.sort_state_by_cell(port, spec)
    assert torch.equal(perm, torch.arange(port.capacity))  # already sorted
    if tag == "ragged":
        assert st.capacity % 128 != 0 and not st.active_mask[st.num_active:].any()
    bounds = grid.csr_bounds(ids, spec)
    return dict(raw=raw, pack=pack, jax_args=jax_args, kw=kw, st_j=st_j, plan=plan,
                params_j=params_j, st=st, ids=ids, bounds=bounds, spec=spec, params=params)


def _rows(a, cap):
    """A JAX per-row array as a torch tensor of ``cap`` rows: cut, or
    padded with 0 (the port's capacity differs from JAX's block multiple;
    the rows past the live particles are inactive on both sides)."""
    a = np.asarray(a)
    return torch.tensor(np.concatenate([a, np.zeros(max(cap - len(a), 0), a.dtype)])[:cap])


def _effm(st, params):
    flm = st.fluid_mask.to(torch.float32) * st.mass
    return flm, flm + st.boundary_mask.to(torch.float32) * (params.density0 * st.volume)


# (dim, boundary particles, _raw's state)
CASES_2D = [(2, False, None), (2, True, None), (2, False, "dense"), (2, True, "lone"),
            (2, True, "ragged")]
IDS_2D = ["2d", "2d_boundary", "2d_dense", "2d_boundary_lone", "2d_boundary_ragged"]
CASES_3D = [(3, False, None), (3, True, None), (3, False, "dense"), (3, True, "lone"),
            (3, True, "ragged")]
IDS_3D = ["3d", "3d_boundary", "3d_dense", "3d_boundary_lone", "3d_boundary_ragged"]


def check_plain_sweeps_match_seg_kernel(dim, boundary, tag=None):
    """The parity check; its 3D cases run from test_torch_sweeps_3d.py so
    that each file's interpret-mode kernels stay within one worker's share."""
    s = _setup(dim, boundary, tag)
    st, ids, bounds, spec, params = s["st"], s["ids"], s["bounds"], s["spec"], s["params"]
    n = st.num_active
    fluid = st.fluid_mask.numpy()[:n]
    valid = np.asarray(s["plan"].back_valid)[:n]
    assert valid[st.active_mask.numpy()[:n]].all()
    flm, effm = _effm(st, params)

    # density
    rho_j = ps.density_sweep_seg(s["pack"], *s["jax_args"], **s["kw"])
    rho = neighbors.density_sweep(neighbors.pack4(st.x, effm), ids, bounds, st.material,
                                  spec, params)
    np.testing.assert_allclose(rho.numpy()[:n][fluid], np.asarray(rho_j)[:n][fluid],
                               rtol=RTOL)

    # force, both sides fed the JAX density through the EOS
    rho_f = jnp.where(s["st_j"].fluid_mask, rho_j, s["st_j"].density)
    rho_f, p_j = jF.compute_pressures(rho_f, s["params_j"])
    dv_j = np.asarray(ps.force_sweep_seg(ps.repack_eos(s["pack"], rho_f, p_j),
                                         *s["jax_args"], **s["kw"]))[:n]
    rho_t, p_t = _rows(rho_f, st.capacity), _rows(p_j, st.capacity)
    aux = neighbors.pack_aux(p_t / torch.clamp(rho_t * rho_t, min=1e-12), flm, st.mass)
    dv = neighbors.force_sweep(neighbors.pack4(st.x, effm), neighbors.pack4(st.v, rho_t),
                               aux, ids, bounds, st.material, spec, params).numpy()[:n]
    scale = np.abs(dv_j[fluid]).max()
    np.testing.assert_allclose(dv[fluid] / scale, dv_j[fluid] / scale, atol=FORCE_ATOL)

    # bvol (boundary rows), and every mode is 0 outside its row family
    bd = st.boundary_mask.numpy()[:n]
    delta = neighbors.bvol_sweep(neighbors.pack4(st.x, st.boundary_mask.to(torch.float32)),
                                 ids, bounds, st.material, spec, params).numpy()[:n]
    if boundary:
        delta_j = np.asarray(ps.bvol_sweep_seg(s["pack"], *s["jax_args"], **s["kw"]))[:n]
        np.testing.assert_allclose(delta[bd], delta_j[bd], rtol=RTOL)
    assert bd.any() == boundary
    assert (delta[~bd] == 0).all() and (rho.numpy()[:n][~fluid] == 0).all()
    assert (dv[~fluid] == 0).all()
    if tag == "lone":
        # the last fluid block's one particle: no neighbour inside h, so its
        # density is its self term and its force is gravity alone
        r = st.x[:n] - st.x[:n][:, None]
        alone = ((r * r).sum(-1) < params.support_length ** 2).sum(1) == 1
        assert int(alone.sum()) == 1 and fluid[alone.numpy()].all()
        k = int(torch.nonzero(alone)[0])
        assert np.array_equal(dv[k], np.asarray(params.gravity, dtype=np.float32))
        assert rho.numpy()[k] == rho.numpy()[:n][fluid].min()


@pytest.mark.parametrize("dim,boundary,tag", CASES_2D, ids=IDS_2D)
def test_plain_sweeps_match_seg_kernel(dim, boundary, tag):
    check_plain_sweeps_match_seg_kernel(dim, boundary, tag)


def test_sweep_wrappers_take_plain_versions_on_cpu():
    s = _setup(2, True)
    st, ids, bounds, spec, params = s["st"], s["ids"], s["bounds"], s["spec"], s["params"]
    flm, effm = _effm(st, params)
    pos = neighbors.pack4(st.x, effm)
    vel = neighbors.pack4(st.v, st.density)
    aux = neighbors.pack_aux(F.compute_pressures(st.density, params)[1] / 1e6, flm, st.mass)
    before = profiling.launch_counters()
    assert torch.equal(cuda_sweeps.density_sweep(pos, ids, bounds, st.material, spec, params),
                       neighbors.density_sweep(pos, ids, bounds, st.material, spec, params))
    assert torch.equal(
        cuda_sweeps.force_sweep(pos, vel, aux, ids, bounds, st.material, spec, params),
        neighbors.force_sweep(pos, vel, aux, ids, bounds, st.material, spec, params))
    assert torch.equal(cuda_sweeps.bvol_sweep(pos, ids, bounds, st.material, spec, params),
                       neighbors.bvol_sweep(pos, ids, bounds, st.material, spec, params))
    assert profiling.launch_counters() == before


@pytest.mark.parametrize("mode,lanes,below", [
    ("density", 4, 600_000), ("force", 4, 300_000), ("bvol", 8, 600_000),
    ("force_react", 4, 300_000), ("reaction", 8, 300_000)])
def test_launch_shape_is_a_rule_of_the_row_count(mode, lanes, below):
    """Small launches give a row several lanes of a 128-thread CTA, large
    ones one thread; the CTAs cover every row."""
    for n in (1, 127, 129, 60_864, 195_304, below - 1):
        got, ctas = cuda_sweeps.launch_shape(mode, n)
        assert got == lanes and (ctas - 1) * (128 // lanes) < n <= ctas * (128 // lanes)
    for n in (below, 1_000_000):
        assert cuda_sweeps.launch_shape(mode, n) == (1, -(-n // 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dim,boundary,tag", CASES_2D + CASES_3D + [(3, False, "many")],
                         ids=IDS_2D + IDS_3D + ["3d_many"])
def test_kernel_matches_plain_on_cuda(dim, boundary, tag):
    """All three modes at both fast_math settings on every state above and
    on MANY; two calls on the same input are bitwise equal (a row's lanes
    add their partial sums in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    raw = _raw(dim, boundary, tag)
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cuda")
    state = pt.build_state(scene, device="cuda")
    if tag == "ragged":
        state = pad_state_capacity(state, _ragged(state.capacity))
        assert state.capacity % 128 != 0
    gen = torch.Generator(device="cpu").manual_seed(7)  # viscosity terms not all 0
    state = dataclasses.replace(state, v=state.v + 0.5 * state.active_mask[:, None]
                                * torch.randn(state.v.shape, generator=gen).to("cuda"))
    state = solver.bind(state)
    st, ids, _ = grid.sort_state_by_cell(state, solver.spec)
    bounds = grid.csr_bounds(ids, solver.spec)
    spec, params = solver.spec, solver.params
    flm, effm = _effm(st, params)
    pos = neighbors.pack4(st.x, effm)
    rho = neighbors.density_sweep(pos, ids, bounds, st.material, spec, params)
    rho, p = F.compute_pressures(torch.where(st.fluid_mask, rho, st.density), params)
    vel = neighbors.pack4(st.v, rho)
    aux = neighbors.pack_aux(p / torch.clamp(rho * rho, min=1e-12), flm, st.mass)
    pos_b = neighbors.pack4(st.x, st.boundary_mask.to(torch.float32))
    fl, bd = st.fluid_mask, st.boundary_mask
    d_args = (ids, bounds, st.material, spec, params)
    for fast, force_atol in ((False, FORCE_ATOL), (True, 2 * FORCE_ATOL)):
        got = cuda_sweeps.density_sweep(pos, *d_args, fast)
        assert torch.equal(got, cuda_sweeps.density_sweep(pos, *d_args, fast))
        want = neighbors.density_sweep(pos, *d_args)
        torch.testing.assert_close(got[fl], want[fl], rtol=RTOL, atol=0)
        assert torch.equal(got[~fl], torch.zeros_like(got[~fl]))
        got = cuda_sweeps.bvol_sweep(pos_b, *d_args, fast)
        assert torch.equal(got, cuda_sweeps.bvol_sweep(pos_b, *d_args, fast))
        want = neighbors.bvol_sweep(pos_b, *d_args)
        torch.testing.assert_close(got[bd], want[bd], rtol=RTOL, atol=0)
        assert torch.equal(got[~bd], torch.zeros_like(got[~bd]))
        got = cuda_sweeps.force_sweep(pos, vel, aux, *d_args, fast)
        assert torch.equal(got, cuda_sweeps.force_sweep(pos, vel, aux, *d_args, fast))
        want = neighbors.force_sweep(pos, vel, aux, *d_args)
        scale = want[fl].abs().max()
        torch.testing.assert_close(got[fl] / scale, want[fl] / scale, rtol=0, atol=force_atol)
        assert torch.equal(got[~fl], torch.zeros_like(got[~fl]))


def _coupling_raw(dim):
    """A boundary block standing for a rigid body, half inside a fluid
    sampled at rest spacing (so that pressure does not swamp viscosity)."""
    raw = _raw(dim, False)
    raw["fluidBlocks"][0]["spacing"] = "diameter"
    raw["boundaryBlocks"] = [{"start": [0.4, 0.3, 0.35][:dim], "end": [0.65, 0.5, 0.6][:dim]}]
    return raw


def _coupling_setup(dim, ragged=False):
    """JAX seg inputs of a coupled substep (``ragged``: at a capacity that
    is no multiple of 128, so a warp of the kernel mixes fluid, boundary
    and inactive rows): seeded non-zero velocities on
    every particle (the body moves through the fluid), boundary volumes
    from the bvol sweep on these positions, density and EOS from the seg
    kernel; and the same sorted state and packs in the port."""
    raw = _coupling_raw(dim)
    scene = tt.scene_from_dict(raw)
    solver = tt.WCSPH(scene, boundary_mode="per_step", sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
        layout="seg", pad_capacity=8192, fast_math=False))
    state = solver.bind(tt.build_state(scene))
    spec_j, params_j, cfg = solver.spec, solver.params, solver.sweep_cfg
    st_j, ids_j, _ = jgrid.sort_state_by_cell(state, spec_j)
    rng = np.random.default_rng(11)
    st_j = dataclasses.replace(st_j, v=st_j.v + jnp.asarray(
        rng.normal(0.0, 1.0, st_j.v.shape).astype(np.float32)))
    plan = jgrid.seg_plan(ids_j, spec_j, cfg.block_size, cfg.pad_capacity // cfg.block_size)
    meta, _ = ps.seg_block_meta(plan, ids_j, spec_j, cfg.block_size, cfg.window_cap)
    jax_args = (meta, spec_j, params_j, cfg.block_size, cfg.window_cap)
    kw = dict(tile=cfg.tile, interpret=True)

    def pack_of(st):
        return ps.pack_state(st.x, st.v, st.density, st.pressure, st.mass, st.volume,
                             st.material, ids_j, params_j)

    delta = ps.bvol_sweep_seg(pack_of(st_j), *jax_args, **kw)
    bd_j = plan.back_valid & st_j.boundary_mask
    st_j = dataclasses.replace(st_j, volume=jnp.where(bd_j, 1.0 / jnp.maximum(delta, 1e-10),
                                                      st_j.volume))
    pack = pack_of(st_j)
    rho = ps.density_sweep_seg(pack, *jax_args, **kw)
    rho, p = jF.compute_pressures(jnp.where(plan.back_valid & st_j.fluid_mask, rho,
                                            st_j.density), params_j)
    pack = ps.repack_eos(pack, rho, p)

    port = pt.state_from_host(jax_to_host(st_j), "cpu")
    port = pad_state_capacity(port, _ragged(port.capacity) if ragged else st_j.capacity)
    spec = grid.make_grid_spec(dim, scene.domain_start, scene.domain_end, scene.support_length)
    params = pt.SolverParams.from_scene(pt.scene_from_dict(raw))
    st, ids, perm = grid.sort_state_by_cell(port, spec)
    assert torch.equal(perm, torch.arange(port.capacity))  # already sorted
    bounds = grid.csr_bounds(ids, spec)
    flm, effm = _effm(st, params)
    rho_t, p_t = _rows(rho, st.capacity), _rows(p, st.capacity)
    packs = (neighbors.pack4(st.x, effm), neighbors.pack4(st.v, rho_t),
             neighbors.pack_aux(p_t / torch.clamp(rho_t * rho_t, min=1e-12), flm, st.mass))
    return dict(pack=pack, jax_args=jax_args, kw=kw, st=st, ids=ids, bounds=bounds,
                spec=spec, params=params, packs=packs)


def check_coupling_sweeps_match_seg_kernel(dim, ragged=False):
    """force_react and reaction against the seg kernel (its 3D case runs
    from test_torch_sweeps_3d.py); in the plain versions, force_react
    equals force on fluid rows and reaction on boundary rows bitwise, as
    tests/test_seg.py:227-285 checks the TPU kernel."""
    s = _coupling_setup(dim, ragged)
    assert (s["st"].capacity % 128 != 0) or not ragged
    st, spec, params = s["st"], s["spec"], s["params"]
    args = (*s["packs"], s["ids"], s["bounds"], st.material, spec, params)
    n = st.num_active
    fl, bd = st.fluid_mask.numpy(), st.boundary_mask.numpy()
    assert fl[:n].any() and bd[:n].any() and not (fl | bd)[n:].any()
    fr = neighbors.force_react_sweep(*args).numpy()
    rx = neighbors.reaction_sweep(*args).numpy()
    fr_j = np.asarray(ps.force_react_sweep_seg(s["pack"], *s["jax_args"], **s["kw"]))
    rx_j = np.asarray(ps.reaction_sweep_seg(s["pack"], *s["jax_args"], **s["kw"]))
    for got, want, rows in ((fr, fr_j, fl), (fr, fr_j, bd), (rx, rx_j, bd)):
        got, want, rows = got[:n], want[:n], rows[:n]  # the capacities may differ
        scale = np.abs(want[rows]).max()
        assert scale > 0
        np.testing.assert_allclose(got[rows] / scale, want[rows] / scale, rtol=0,
                                   atol=FORCE_ATOL)
    # the body moves: the viscous (dot) term must count in the reaction
    still = (*s["packs"][:1], neighbors.pack4(torch.zeros_like(st.v), s["packs"][1][:, 3]),
             *args[2:])
    assert np.abs(neighbors.reaction_sweep(*still).numpy()[bd] - rx[bd]).max() > 0.1 * np.abs(
        rx[bd]).max()
    assert (fr[~(fl | bd)] == 0).all() and (rx[~bd] == 0).all()
    assert np.array_equal(fr[fl], neighbors.force_sweep(*args).numpy()[fl])
    assert np.array_equal(fr[bd], rx[bd])


def test_coupling_sweeps_match_seg_kernel_2d():
    check_coupling_sweeps_match_seg_kernel(2)


def test_coupling_sweeps_match_seg_kernel_ragged_2d():
    check_coupling_sweeps_match_seg_kernel(2, ragged=True)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("dim", [2, 3])
def test_coupling_kernel_matches_plain_on_cuda(dim, ragged):
    """``ragged``: the sorted state's cells hold fluid and boundary rows
    side by side and the capacity is no multiple of 128, so a warp of
    force_react mixes fluid, boundary and inactive rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    scene = pt.scene_from_dict(_coupling_raw(dim))
    solver = pt.WCSPH(scene, device="cuda")  # its spec and params
    state = pt.build_state(scene, device="cuda")
    if ragged:
        state = pad_state_capacity(state, _ragged(state.capacity))
    gen = torch.Generator(device="cpu").manual_seed(11)
    state = dataclasses.replace(state, v=state.v + state.active_mask[:, None] * torch.randn(
        state.v.shape, generator=gen).to("cuda"))
    st, ids, _ = grid.sort_state_by_cell(state, solver.spec)
    bounds = grid.csr_bounds(ids, solver.spec)
    spec, params = solver.spec, solver.params
    bdm = st.boundary_mask
    delta = neighbors.bvol_sweep(neighbors.pack4(st.x, bdm.to(torch.float32)), ids, bounds,
                                 st.material, spec, params)
    st = dataclasses.replace(st, volume=torch.where(bdm, 1.0 / torch.clamp(delta, min=1e-10),
                                                    st.volume))
    flm, effm = _effm(st, params)
    pos = neighbors.pack4(st.x, effm)
    rho = neighbors.density_sweep(pos, ids, bounds, st.material, spec, params)
    rho, p = F.compute_pressures(torch.where(st.fluid_mask, rho, st.density), params)
    args = (pos, neighbors.pack4(st.v, rho),
            neighbors.pack_aux(p / torch.clamp(rho * rho, min=1e-12), flm, st.mass),
            ids, bounds, st.material, spec, params)
    fl = st.fluid_mask
    want_fr = neighbors.force_react_sweep(*args)
    want_rx = neighbors.reaction_sweep(*args)
    for fast, atol in ((False, FORCE_ATOL), (True, 2 * FORCE_ATOL)):
        got_fr = cuda_sweeps.force_react_sweep(*args, fast)
        got_rx = cuda_sweeps.reaction_sweep(*args, fast)
        assert torch.equal(got_fr, cuda_sweeps.force_react_sweep(*args, fast))
        assert torch.equal(got_rx, cuda_sweeps.reaction_sweep(*args, fast))
        for got, want, rows in ((got_fr, want_fr, fl), (got_fr, want_fr, bdm),
                                (got_rx, want_rx, bdm)):
            scale = want[rows].abs().max()
            torch.testing.assert_close(got[rows] / scale, want[rows] / scale, rtol=0, atol=atol)
        assert torch.equal(got_rx[~bdm], torch.zeros_like(got_rx[~bdm]))
        off = ~(fl | bdm)
        assert torch.equal(got_fr[off], torch.zeros_like(got_fr[off]))
