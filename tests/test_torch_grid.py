"""Port grid parity: gap-padded strides, cell ids, the stable sort (ids AND
permutation), CSR bounds, stencil runs, and the linear layout's target
ranges and block windows equal tisph_tpu's exactly, on numpy-random states
with out-of-domain stragglers and inactive tail slots.
The bounds kernel itself runs on a CUDA card only (the `cuda` test)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops import grid as jgrid

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import pad_state_capacity
from tisph_tpu_torch.ops import grid
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.utils import profiling

from test_pallas import _scene

torch.set_num_threads(2)


def _states(dim, seed, extra=61):
    """The same randomised state in both packages: particles scattered over
    the domain and 3% past its edges, plus ``extra`` inactive slots."""
    ref = tt.build_state(_scene(dim=dim, radius=0.02))
    host = jax_to_host(ref)
    rng = np.random.default_rng(seed)
    n = host["x"].shape[0]
    host["x"] = rng.uniform(-0.03, 1.03, (n, dim)).astype(np.float32)
    port = pad_state_capacity(pt.state_from_host(host, "cpu"), n + extra)
    ref = dataclasses.replace(
        ref, x=jnp.asarray(host["x"]), v=jnp.asarray(host["v"]),
        density=jnp.asarray(host["density"]), pressure=jnp.asarray(host["pressure"]),
        mass=jnp.asarray(host["mass"]), volume=jnp.asarray(host["volume"]),
        material=jnp.asarray(host["material"]), color=jnp.asarray(host["color"]),
        object_id=jnp.asarray(host["object_id"]),
    )
    ref = jax_pad(ref, n + extra)
    spec_j = jgrid.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, 4 * 0.02)
    spec = grid.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, 4 * 0.02)
    return ref, port, spec_j, spec


@pytest.mark.parametrize("domain", [
    ((0, 0), (4, 2), 0.04), ((0, 0, 0), (5, 3, 2), 0.04), ((-1, 0, 2), (0.3, 1.7, 2.9), 0.1),
    ((0, 0, 0), (1.6, 1.0, 1.0), 0.1),
])
def test_grid_spec_matches_jax(domain):
    start, end, h = domain
    a = grid.make_grid_spec(len(start), start, end, h)
    b = jgrid.make_grid_spec(len(start), start, end, h)
    assert (a.res, a.strides, a.num_cells, a.num_rows) == (b.res, b.strides, b.num_cells,
                                                          b.num_rows)


@pytest.mark.parametrize("dim", [2, 3])
def test_sort_bounds_runs_match_jax(dim):
    ref, port, spec_j, spec = _states(dim, seed=dim)
    st_j, ids_j, perm_j = jgrid.sort_state_by_cell(ref, spec_j)
    st, ids, perm = grid.sort_state_by_cell(port, spec)
    assert (ids.numpy() == spec.num_cells).sum() == 61  # the inactive tail
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    for f in ("x", "v", "density", "material", "object_id", "color"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(st_j, f)))

    b = grid.csr_bounds(ids, spec)
    assert b.dtype == torch.int32 and b.shape == (spec.num_cells + 1,)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jgrid.csr_bounds(ids_j, spec_j)))
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(jgrid.csr_bounds_fast(ids_j, spec_j, interpret=True)))

    coords = grid.cell_coords(st.x, spec)
    np.testing.assert_array_equal(coords.numpy(),
                                  np.asarray(jgrid.cell_coords(st_j.x, spec_j)))
    np.testing.assert_array_equal(
        grid.stencil_runs(coords, b, spec).numpy(),
        np.asarray(jgrid.stencil_runs(jnp.asarray(coords.numpy()), jnp.asarray(b.numpy()),
                                      spec_j)))
    act = ids < spec.num_cells
    np.testing.assert_array_equal(grid.coords_from_ids(ids[act], spec).numpy(),
                                  coords[act].numpy())


@pytest.mark.parametrize("dim", [2, 3])
def test_block_windows_match_jax(dim):
    """The linear layout's per-(block, row) windows and per-particle
    target ranges equal JAX's exactly, over the whole array (ragged last
    block, inactive tail) and for an i side that is a row range of the j
    array; the windows read out of the CSR bounds equal the searchsorted
    ones."""
    ref, port, spec_j, spec = _states(dim, seed=10 + dim)
    st_j, ids_j, _ = jgrid.sort_state_by_cell(ref, spec_j)
    st, ids, _ = grid.sort_state_by_cell(port, spec)
    n = ids.shape[0]
    assert n % 128 and (ids == spec.num_cells).sum() == 61
    coords = grid.cell_coords(st.x, spec)
    coords_j = jnp.asarray(coords.numpy())
    np.testing.assert_array_equal(grid.cell_target_ranges(coords, spec).numpy(),
                                  np.asarray(jgrid.cell_target_ranges(coords_j, spec_j)))
    b = grid.csr_bounds(ids, spec)
    for o in (0, 300):  # all rows; rows [300, n) of the j array
        want = jgrid.block_window_bounds(ids_j, coords_j[o:], spec_j, 128, ids_i=ids_j[o:])
        plain = grid.block_window_bounds(ids, coords[o:], spec, 128, ids_i=ids[o:])
        from_bounds = grid.block_window_bounds(ids, coords[o:], spec, 128, ids_i=ids[o:],
                                               bounds=b)
        assert plain[0].shape == (-(-(n - o) // 128), spec.num_rows)
        for got in (plain, from_bounds):
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (plain[1] > plain[0]).any()  # not all empty


def test_bounds_wrapper_takes_plain_version_on_cpu():
    _, port, _, spec = _states(3, seed=7)
    _, ids, _ = grid.sort_state_by_cell(port, spec)
    before = profiling.launch_counters()
    got = cuda_bounds.csr_bounds_sorted(ids, spec)
    assert profiling.launch_counters() == before
    assert torch.equal(got, grid.csr_bounds(ids, spec))


@pytest.mark.cuda
def test_bounds_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bounds kernel has no CPU mode")
    _, port, _, spec = _states(3, seed=8)
    _, ids, _ = grid.sort_state_by_cell(port, spec)
    ids = ids.cuda()
    cases = [ids, ids[:1].clone(),
             torch.full((500,), spec.num_cells, dtype=torch.int32, device="cuda")]
    for c in cases:
        got = cuda_bounds.csr_bounds_sorted(c, spec)
        torch.cuda.synchronize()
        assert torch.equal(got, grid.csr_bounds(c, spec))
