"""The port's rebuild (``ops.cuda.bounds.sort_and_bound``): on the CPU its
plain path equals tisph_tpu's ``sort_state_by_cell`` plus
``csr_bounds_fast`` (the Pallas bounds kernel in interpret mode) bit for
bit, fields, sorted ids, permutation and bounds, in 2D and 3D, on states
with an inactive tail, a dense cell and an empty domain edge; the
wrappers take the plain version on the CPU without counting a launch and
refuse what the kernel does not take.  The front of a small state
(``cell_sort``: the cell ids and their stable sort in one launch) is
taken by its row count alone, and its plain version equals tisph_tpu's
sorted ids and permutation.  The kernels themselves run on a CUDA card
only (the `cuda` tests)."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tisph_tpu.models.state import SimState as JState
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.ops import grid as jgrid

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import MATERIAL_INVALID, pad_state_capacity
from tisph_tpu_torch.ops import grid
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = ["tail", "dense_cell", "empty_edge"]
H = 0.08  # support length: a grid of 13 cells an axis over the unit box


def _host(dim, case, seed, n=1500):
    """Live particles of ``case``, made with numpy: ``tail`` scatters them
    over the domain and 3% past its edges; ``dense_cell`` puts 40% of them
    inside one cell (more ids than a bounds CTA of the kernel holds, at
    the larger sizes of the cuda test); ``empty_edge`` keeps them all in
    the middle fifth of every axis, so every cell near the walls is
    empty."""
    rng = np.random.default_rng(seed)
    if case == "tail":
        x = rng.uniform(-0.03, 1.03, (n, dim))
    elif case == "dense_cell":
        x = rng.uniform(0.0, 1.0, (n, dim))
        x[: 2 * n // 5] = rng.uniform(0.41, 0.47, (2 * n // 5, dim))
    else:
        x = rng.uniform(0.4, 0.6, (n, dim))
    return {
        "x": x.astype(np.float32),
        "v": rng.normal(size=(n, dim)).astype(np.float32),
        "density": rng.uniform(900, 1100, n).astype(np.float32),
        "pressure": rng.normal(size=n).astype(np.float32),
        "mass": rng.uniform(0.1, 1.0, n).astype(np.float32),
        "volume": rng.uniform(1e-6, 1e-5, n).astype(np.float32),
        "material": rng.integers(0, 2, n).astype(np.int32),
        "color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "object_id": rng.integers(0, 5, n).astype(np.int32),
        "num_active": np.asarray(n),
    }


def _states(dim, case, seed=0, extra=61):
    """The same state in both packages, ``extra`` inactive slots at the
    tail, and the two packages' grid specs."""
    host = _host(dim, case, seed)
    n = int(host["num_active"])
    port = pad_state_capacity(pt.state_from_host(host, "cpu"), n + extra)
    ref = JState(**{k: jnp.asarray(v) for k, v in host.items() if k != "num_active"},
                 num_active=jnp.asarray(n, jnp.int32))
    ref = jax_pad(ref, n + extra)
    spec = grid.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, H)
    spec_j = jgrid.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, H)
    return port, ref, spec, spec_j


def _bits(t):
    """The tensor's words as int32, so that equality is bitwise."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", [2, 3])
def test_sort_and_bound_matches_jax(dim, case):
    port, ref, spec, spec_j = _states(dim, case, seed=dim)
    st, ids, perm, bounds = cuda_bounds.sort_and_bound(port, spec)
    st_j, ids_j, perm_j = jgrid.sort_state_by_cell(ref, spec_j)
    bounds_j = jgrid.csr_bounds_fast(ids_j, spec_j, interpret=True)

    assert (ids.numpy() == spec.num_cells).sum() == 61  # the inactive tail
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(perm.to(torch.int32).numpy(), np.asarray(perm_j))
    assert bounds.dtype == torch.int32 and bounds.shape == (spec.num_cells + 1,)
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(bounds_j))
    for name in grid.state_fields(st):
        got, want = getattr(st, name), np.asarray(getattr(st_j, name))
        assert got.numpy().dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(_bits(got).numpy(), want.view(np.int32), err_msg=name)
    assert st.num_active == port.num_active

    counts = np.diff(bounds.numpy())
    if case == "dense_cell":
        assert counts.max() >= 2 * 1500 // 5  # one cell holds the crowd
    if case == "empty_edge":
        res = spec.res
        assert counts[: spec.strides[0]].sum() == 0  # the whole x = 0 wall of cells
        assert counts[(res[0] - 1) * spec.strides[0]:].sum() == 0


def test_rebuild_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors every wrapper returns the plain version's result and
    counts no launch."""
    port, _, spec, _ = _states(3, "tail", seed=5)
    before = profiling.launch_counters()
    st, ids, perm, bounds = cuda_bounds.sort_and_bound(port, spec)
    st2, bounds2 = cuda_bounds.gather_and_bound(port, ids, perm, spec)
    bounds3 = cuda_bounds.csr_bounds_sorted(ids, spec)
    assert profiling.launch_counters() == before
    plain_st, plain_ids, plain_perm = grid.sort_state_by_cell(port, spec)
    plain_bounds = grid.csr_bounds(plain_ids, spec)
    assert torch.equal(ids, plain_ids) and torch.equal(perm, plain_perm)
    for b in (bounds, bounds2, bounds3):
        assert torch.equal(b, plain_bounds)
    for name in grid.state_fields(st):
        for s in (st, st2):
            assert torch.equal(_bits(getattr(s, name)), _bits(getattr(plain_st, name))), name


@pytest.mark.parametrize("fault", ["f64_field", "strided_field", "meta_device"])
def test_sort_and_bound_refuses(fault):
    """A field the kernel does not take (not 4 bytes wide, not
    contiguous) and a device other than the CPU or CUDA raise, on every
    device, rather than falling back."""
    port, _, spec, _ = _states(2, "tail", seed=9)
    if fault == "f64_field":
        port = dataclasses.replace(port, density=port.density.double())
        match = "not 4 bytes"
    elif fault == "strided_field":
        port = dataclasses.replace(port, x=port.x.t().contiguous().t())
        match = "contiguous"
    else:
        port = pt.SimState(**{k: getattr(port, k).to("meta") for k in grid.state_fields(port)},
                           num_active=port.num_active)
        match = "unsupported device"
    with pytest.raises(ValueError, match=match):
        cuda_bounds.sort_and_bound(port, spec)


@pytest.mark.parametrize("rows, taken", [(6_304, True), (8_192, True), (8_193, False),
                                         (195_304, False), (1_000_000, False)])
def test_cell_sort_rule_is_the_row_count(rows, taken):
    """sort_and_bound's front is cell_sort up to SMALL_SORT_ROWS rows, the
    kernel's capacity as csrc/cell_sort.cu builds it: at demo_2d's 6,304
    rows and at 8,192; the torch sequence above, at demo_3d's 195,304 rows
    and dam_1m's 1,000,000, which cell_sort itself refuses."""
    src = (ROOT / "tisph_tpu_torch" / "csrc" / "cell_sort.cu").read_text()
    built = [int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("kThreads", "kItems")]
    assert cuda_bounds.SMALL_SORT_ROWS == built[0] * built[1] == 8_192
    assert (rows <= cuda_bounds.SMALL_SORT_ROWS) == taken
    spec = grid.make_grid_spec(2, [0.0] * 2, [1.0] * 2, H)
    x, mat = torch.full((rows, 2), 0.5), torch.zeros((rows,), dtype=torch.int32)
    if taken:
        ids, perm = cuda_bounds.cell_sort(x, mat, spec)
        assert torch.equal(perm, torch.arange(rows)) and bool((ids == ids[0]).all())
    else:
        with pytest.raises(ValueError, match="the kernel holds 8192"):
            cuda_bounds.cell_sort(x, mat, spec)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", [2, 3])
def test_cell_sort_takes_the_plain_version_on_cpu(dim, case):
    """On CPU tensors cell_sort is grid.cell_sort (the ids, then a stable
    torch.sort), counts no launch, and equals tisph_tpu's sorted ids and
    permutation (its sort_key_val)."""
    port, ref, spec, spec_j = _states(dim, case, seed=dim + 10)
    before = profiling.launch_counters()
    ids, perm = cuda_bounds.cell_sort(port.x, port.material, spec)
    assert profiling.launch_counters() == before
    plain_ids, plain_perm = grid.cell_sort(port.x, port.material, spec)
    want = torch.sort(grid.flat_cell_ids(grid.cell_coords(port.x, spec), port.material, spec),
                      stable=True)
    assert ids.dtype == torch.int32 and perm.dtype == torch.int64
    for got in ((ids, perm), (plain_ids, plain_perm)):
        assert torch.equal(got[0], want.values) and torch.equal(got[1], want.indices)
    _, ids_j, perm_j = jgrid.sort_state_by_cell(ref, spec_j)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(perm.to(torch.int32).numpy(), np.asarray(perm_j))


@pytest.mark.parametrize("fault", ["too_many_rows", "meta_device"])
def test_cell_sort_refuses(fault):
    """cell_sort raises, on every device, on more rows than the kernel
    holds, and on a device other than the CPU or CUDA (a wrong dtype,
    shape or device on the card: the `cuda` test)."""
    port, _, spec, _ = _states(2, "tail", seed=9)
    x, mat = port.x, port.material
    if fault == "too_many_rows":
        n = cuda_bounds.SMALL_SORT_ROWS + 1
        x, mat = torch.zeros((n, 2)), torch.zeros((n,), dtype=torch.int32)
        match = "the kernel holds"
    else:
        x, mat, match = x.to("meta"), mat.to("meta"), "unsupported device"
    with pytest.raises(ValueError, match=match):
        cuda_bounds.cell_sort(x, mat, spec)


def _front_cases():
    """(label, state, spec) on the card for the front: rows in one cell,
    in reverse cell order, on the cells' edges (each coordinate k h and
    one float step either side), NaN, infinite and far-out rows, an
    inactive tail, 3D, and the row counts where the rule changes
    (SMALL_SORT_ROWS, SMALL_SORT_ROWS + 1)."""
    spec2 = grid.make_grid_spec(2, [0.0] * 2, [1.0] * 2, H)
    spec3 = grid.make_grid_spec(3, [0.0] * 3, [1.0] * 3, H)
    rng = np.random.default_rng(27)

    def state(host, x, dim, extra=0):
        host = host | {"x": np.ascontiguousarray(x, dtype=np.float32)}
        st = pt.state_from_host(host, "cuda")
        return pad_state_capacity(st, st.capacity + extra) if extra else st

    out = []
    host = _host(2, "tail", seed=3, n=6_000)
    out.append(("2d_tail", state(host, host["x"], 2, extra=304), spec2))
    out.append(("one_cell", state(host, rng.uniform(0.41, 0.47, (6_000, 2)), 2), spec2))
    ids = grid.flat_cell_ids(grid.cell_coords(torch.from_numpy(host["x"]), spec2),
                             torch.from_numpy(host["material"]), spec2)
    order = torch.sort(ids, stable=True).indices.numpy()[::-1]
    out.append(("reverse", state(host, host["x"][order], 2), spec2))
    k = rng.integers(0, 13, (6_000, 2)).astype(np.float32) * np.float32(H)
    step = rng.integers(-1, 2, (6_000, 2))
    edges = np.where(step < 0, np.nextafter(k, np.float32(-1)),
                     np.where(step > 0, np.nextafter(k, np.float32(2)), k))
    out.append(("cell_edges", state(host, edges, 2), spec2))
    odd = host["x"].copy()
    odd[::7, 0] = np.nan
    odd[1::7, 1] = np.inf
    odd[2::7, 0] = -np.inf
    odd[3::7, 1] = 1e30
    odd[4::7, 0] = -1e30
    out.append(("nan_inf_far", state(host, odd, 2), spec2))
    host3 = _host(3, "dense_cell", seed=4, n=4_000)
    out.append(("3d_crowd", state(host3, host3["x"], 3, extra=96), spec3))
    for n in (cuda_bounds.SMALL_SORT_ROWS, cuda_bounds.SMALL_SORT_ROWS + 1):
        h = _host(2, "tail", seed=n, n=n)
        out.append((f"rows_{n}", state(h, h["x"], 2), spec2))
    return out


def _cuda_cases():
    """(label, state, spec) on the card: the CPU cases at 40x the rows,
    the dense cell then holding 24,000 ids, more than a bounds CTA stages
    (``ITEMS_PER_CTA``); an all-inactive state; one particle."""
    out = []
    for dim in (2, 3):
        for case in CASES:
            host = _host(dim, case, seed=dim, n=60_000)
            st = pad_state_capacity(pt.state_from_host(host, "cuda"), 60_000 + 1_001)
            spec = grid.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, H)
            out.append((f"{dim}d_{case}", st, spec))
    host = _host(3, "tail", seed=1, n=2_000)
    spec = grid.make_grid_spec(3, [0.0] * 3, [1.0] * 3, H)
    st = pt.state_from_host(host, "cuda")
    out.append(("all_inactive", dataclasses.replace(
        st, material=torch.full_like(st.material, MATERIAL_INVALID)), spec))
    host = _host(3, "tail", seed=2, n=1)
    out.append(("one_particle", pt.state_from_host(host, "cuda"), spec))
    return out


@pytest.mark.cuda
def test_rebuild_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rebuild kernel has no CPU mode")
    for label, state, spec in _cuda_cases() + _front_cases():
        before = profiling.counters()
        st, ids, perm, bounds = cuda_bounds.sort_and_bound(state, spec)
        rose = {k: profiling.counters().get(f"launches.{k}", 0) - before.get(f"launches.{k}", 0)
                for k in ("sort_and_bound", "cell_sort")}
        plain_st, plain_ids, plain_perm = grid.sort_state_by_cell(state, spec)
        plain_bounds = grid.csr_bounds(plain_ids, spec)
        only_bounds = cuda_bounds.csr_bounds_sorted(ids, spec)
        torch.cuda.synchronize()
        small = state.capacity <= cuda_bounds.SMALL_SORT_ROWS
        assert rose == {"sort_and_bound": 1, "cell_sort": int(small)}, (label, rose)
        if small:
            front = cuda_bounds.cell_sort(state.x, state.material, spec)
            torch.cuda.synchronize()
            assert torch.equal(front[0], plain_ids) and torch.equal(front[1], plain_perm), label
        assert torch.equal(ids, plain_ids) and torch.equal(perm, plain_perm), label
        assert torch.equal(bounds, plain_bounds), label
        assert torch.equal(only_bounds, plain_bounds), label
        for name in grid.state_fields(st):
            assert torch.equal(_bits(getattr(st, name)), _bits(getattr(plain_st, name))), \
                (label, name)
        if label.endswith("dense_cell"):
            assert int(torch.diff(bounds).max()) > cuda_bounds.ITEMS_PER_CTA, label
    # cell_sort refuses on the card what the kernel does not take
    spec = grid.make_grid_spec(2, [0.0] * 2, [1.0] * 2, H)
    x = torch.full((100, 2), 0.5, device="cuda")
    mat = torch.zeros((100,), dtype=torch.int32, device="cuda")
    for bad_x, bad_mat, match in ((x.double(), mat, "x must be"),
                                  (x, mat.long(), "material must be"),
                                  (x.repeat(1, 2)[:, :2], mat, "x must be contiguous"),
                                  (torch.zeros((100, 3), device="cuda"), mat, "x must be"),
                                  (x, mat.cpu(), "material on cpu")):
        with pytest.raises(ValueError, match=match):
            cuda_bounds.cell_sort(bad_x, bad_mat, spec)
