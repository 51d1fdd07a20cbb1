"""The R-group rebuild: the CUDA kernel ``csrc/bounds.cu`` and its dispatch.

The kernel replaces ``tisph_tpu/ops/pallas/bounds.py::_bounds_kernel``
(the CSR cell bounds, launched by ``csr_bounds_sorted`` there and called
from ``grid.csr_bounds_fast``) and, in the same launch, the row gather of
``tisph_tpu.ops.grid.sort_state_by_cell``: after the cell sort, one launch
writes the bounds and every state field in sorted order.

- :func:`sort_and_bound` is the rebuild of ``WCSPH._build``: the cell
  ids and their stable sort (the front), then the kernel.  Its plain
  version is ``grid.sort_state_by_cell`` then ``grid.csr_bounds``.
- :func:`cell_sort` is the front of a small state in one launch of
  ``csrc/cell_sort.cu`` (one CTA); plain version ``grid.cell_sort`` (the
  ids, then ``torch.sort``), which ``sort_and_bound`` runs on the card
  above ``SMALL_SORT_ROWS`` rows.
- :func:`gather_and_bound` is the kernel's part alone, on a sort already
  made.
- :func:`csr_bounds_sorted` is the counterpart of the JAX function of that
  name: the same kernel with no field to gather; plain version
  ``grid.csr_bounds`` (``torch.searchsorted``).

A CPU tensor goes to the plain version, a CUDA tensor launches the kernel
or raises.  ``launches.sort_and_bound`` in ``utils.profiling``'s registry
counts the rebuild's launches (``gather_and_bound``'s among them),
``launches.csr_bounds_sorted`` the bounds-only ones and
``launches.cell_sort`` the small-state fronts.
"""

from __future__ import annotations

import array
import dataclasses

import numpy as np
import torch

from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.grid import GridSpec

# merged positions (cells + ids) per bounds CTA of csrc/bounds.cu; a
# multiple of 4, and its window of ids (4 B each) stays in the 48 KB of
# shared memory a launch gets without asking
ITEMS_PER_CTA = 2048
_MAX_FIELDS, _MAX_WIDTH = 9, 3  # the kernel's field table
# csrc/cell_sort.cu's capacity (one CTA of 1,024 threads, 8 rows a
# thread), and sort_and_bound's rule: cell_sort up to this many rows, the
# torch sequence (grid.cell_sort) above.  On an H100 80GB HBM3 at 700 W
# (python -m tisph_tpu_torch.kernel_times --front) the kernel takes
# 0.0128 ms at 6,304 rows and 0.0138 at 8,192, the torch sequence
# 0.22-0.29 and torch.sort of the ids alone 0.056-0.064: no crossover
# below the capacity, so the rule takes the kernel up to there
SMALL_SORT_ROWS = 8192


def _check_ids(name: str, sorted_ids: torch.Tensor, spec: GridSpec, perm=None) -> None:
    """(N,) int32 ids and, where given, an (N,) int64 ``perm``
    (``build.check_tensors``); the ids 16-byte aligned, ids plus cells in
    int32."""
    n = sorted_ids.shape[0] if sorted_ids.dim() else 0
    tensors = {"ids": (sorted_ids, torch.int32, (n,))}
    if perm is not None:
        tensors["perm"] = (perm, torch.int64, (n,))
    build.check_tensors(name, n, spec.dim, tensors)
    if sorted_ids.data_ptr() % 16:
        raise ValueError(f"{name}: ids must be contiguous and 16-byte aligned")
    if n + spec.num_cells + 1 >= 2**31:
        raise ValueError(f"{name}: ids plus cells must fit in int32")


def _width(t: torch.Tensor) -> int:
    return t.shape[1] if t.dim() == 2 else 1


def _check_fields(state: SimState) -> list[str]:
    """The fields the kernel gathers; raises on one it does not take (one
    test per field on the host's launch path, the message only on a
    fault)."""
    names = gridops.state_fields(state)
    n, dev = state.capacity, state.device
    if len(names) > _MAX_FIELDS:
        raise ValueError(f"sort_and_bound: {len(names)} fields, the kernel takes {_MAX_FIELDS}")
    for name in names:
        t = getattr(state, name)
        if (t.element_size() != 4 or not t.is_contiguous() or t.device != dev
                or t.shape[0] != n or t.dim() > 2 or _width(t) > _MAX_WIDTH):
            if t.element_size() != 4:
                why = f"is {t.dtype}, not 4 bytes wide"
            elif not t.is_contiguous():
                why = "must be contiguous"
            else:
                why = f"must be (N,) or (N, <= 3) on {dev}, got {tuple(t.shape)} on {t.device}"
            raise ValueError(f"sort_and_bound: field {name!r} {why}")
    return names


def _launch(name: str, sorted_ids, perm, spec: GridSpec, src=(), dst=()) -> torch.Tensor:
    """One launch of csrc/bounds.cu: the bounds of ``sorted_ids`` and, for
    each (src, dst) pair, dst[k] = src[perm[k]]; returns the bounds.  The
    field table goes to C as one int64 array: every src pointer, every dst
    pointer, every width."""
    out = torch.empty((spec.num_cells + 1,), dtype=torch.int32, device=sorted_ids.device)
    table = array.array("q", [t.data_ptr() for t in src] + [t.data_ptr() for t in dst]
                        + [_width(t) for t in src])
    build.launch(name, "tisph_rebuild", sorted_ids.device,
                 sorted_ids.data_ptr(), perm.data_ptr() if perm is not None else None,
                 sorted_ids.shape[0], spec.num_cells, out.data_ptr(), ITEMS_PER_CTA, len(src),
                 table.buffer_info()[0])
    return out


def gather_and_bound(state: SimState, sorted_ids: torch.Tensor, perm: torch.Tensor,
                     spec: GridSpec) -> tuple[SimState, torch.Tensor]:
    """(state reordered by ``perm``, bounds of ``sorted_ids``): the rebuild
    after the sort.  ``sorted_ids`` (M,) int32 ascending with the inactive
    tail = ``spec.num_cells``, ``perm`` (M,) int64, the sort's
    permutation; M is the state's capacity, or fewer when only some
    sorted rows are wanted (row k of the result is row perm[k]).  Every
    field must be 4 bytes wide and contiguous."""
    names = _check_fields(state)
    dev = state.device
    if dev.type == "cpu":
        return gridops.gather_state(state, perm), gridops.csr_bounds(sorted_ids, spec)
    if dev.type != "cuda":
        raise ValueError(f"sort_and_bound: unsupported device {dev}")
    _check_ids("sort_and_bound", sorted_ids, spec, perm)
    n = sorted_ids.shape[0]
    if n > state.capacity or sorted_ids.device != dev:
        raise ValueError(f"sort_and_bound: need ({n},) int32 ids and int64 perm on {dev}, "
                         f"at most the state's {state.capacity} rows")
    src = [getattr(state, k) for k in names]
    dst = [t.new_empty((n,) + tuple(t.shape[1:])) for t in src]
    bounds = _launch("sort_and_bound", sorted_ids, perm, spec, src, dst)
    return dataclasses.replace(state, **dict(zip(names, dst))), bounds


def sort_and_bound(state: SimState, spec: GridSpec
                   ) -> tuple[SimState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted_state, sorted_ids, perm, bounds) of the rebuild: a stable
    sort of the rows by cell id, every field in that order, and the CSR
    bounds (``bounds[c]`` = first sorted index with id >= c).  On the CPU
    ``grid.sort_state_by_cell`` then ``grid.csr_bounds``; on a CUDA state
    the front (``cell_sort``'s one launch up to ``SMALL_SORT_ROWS`` rows,
    else the cell ids and ``torch.sort``) and one launch of the kernel."""
    if state.device.type == "cpu":
        _check_fields(state)
        st, ids, perm = gridops.sort_state_by_cell(state, spec)
        return st, ids, perm, gridops.csr_bounds(ids, spec)
    if state.device.type != "cuda":
        raise ValueError(f"sort_and_bound: unsupported device {state.device}")
    front = cell_sort if state.capacity <= SMALL_SORT_ROWS else gridops.cell_sort
    sorted_ids, perm = front(state.x, state.material, spec)
    st, bounds = gather_and_bound(state, sorted_ids, perm, spec)
    return st, sorted_ids, perm, bounds


def cell_sort(x: torch.Tensor, material: torch.Tensor, spec: GridSpec
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted_ids, perm) of ``grid.cell_sort``: the rows' flat cell ids
    ((N,) int32, inactive rows ``spec.num_cells``) sorted stably, and the
    permutation ((N,) int64).  ``x`` (N, dim) float32 and ``material``
    (N,) int32, contiguous, on one device, N <= ``SMALL_SORT_ROWS``.  On
    the CPU the plain version; on the card one launch of
    ``csrc/cell_sort.cu``, bitwise the plain version there."""
    n = x.shape[0]
    if n > SMALL_SORT_ROWS:
        raise ValueError(f"cell_sort: {n} rows, the kernel holds {SMALL_SORT_ROWS}")
    if x.device.type == "cpu":
        return gridops.cell_sort(x, material, spec)
    build.check_tensors("cell_sort", n, spec.dim, {"x": (x, torch.float32, (n, spec.dim)),
                                                   "material": (material, torch.int32, (n,))})
    if spec.num_cells >= 2**31 - 1:
        raise ValueError(f"cell_sort: {spec.num_cells} cells do not fit in int32")
    pad = 3 - spec.dim
    start = [float(np.float32(s)) for s in spec.domain_start] + [0.0] * pad
    inv_cell = float(np.float32(1.0) / np.float32(spec.cell_size))  # torch's x / cell
    hi = [r - 1 for r in spec.res] + [0] * pad
    strides = list(spec.strides) + [0] * pad
    sorted_ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    perm = torch.empty((n,), dtype=torch.int64, device=x.device)
    build.launch("cell_sort", "tisph_cell_sort", x.device, x.data_ptr(), material.data_ptr(),
                 n, spec.dim, *start, inv_cell, *hi, *strides, spec.num_cells,
                 spec.num_cells.bit_length(), sorted_ids.data_ptr(), perm.data_ptr())
    return sorted_ids, perm


def csr_bounds_sorted(sorted_ids: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """bounds[c] = first sorted index with id >= c, for c in [0,
    num_cells]: (num_cells + 1,) int32.  ``sorted_ids``: (N,) int32,
    ascending, inactive tail = ``spec.num_cells``."""
    if sorted_ids.device.type == "cpu":
        return gridops.csr_bounds(sorted_ids, spec)
    if sorted_ids.device.type != "cuda":
        raise ValueError(f"csr_bounds_sorted: unsupported device {sorted_ids.device}")
    _check_ids("csr_bounds_sorted", sorted_ids, spec)
    return _launch("csr_bounds_sorted", sorted_ids, None, spec)
