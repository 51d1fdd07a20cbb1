"""Uniform-grid binning: cell ids, a stable sort by cell, CSR bounds and
per-particle stencil runs.

The same contract as ``tisph_tpu.ops.grid``, so sorted ids, permutations
and bounds are equal between the two packages.  Cell size = support
length; flat ids are row-major (last axis fastest) with the gap-padded
strides of :class:`GridSpec`.  With that order the 3^dim cells around a
particle are 3^(dim-1) contiguous runs of the sorted particle array, one
per *stencil row* (the particle's neighbouring leading coordinates, z-1 to
z+1 in the fastest axis).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from tisph_tpu_torch.models.state import MATERIAL_INVALID, SimState
from tisph_tpu_torch.ops.consts import device_constant


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry: cell size = support length, resolution =
    ceil(domain size / cell)."""

    dim: int
    domain_start: tuple[float, ...]
    domain_end: tuple[float, ...]
    cell_size: float
    res: tuple[int, ...]

    @property
    def num_cells(self) -> int:
        """Size of the flat id space; also the inactive sentinel id.  With
        the padded strides this exceeds prod(res) by the gap rows."""
        return int(self.res[0] * self.strides[0])

    @property
    def num_rows(self) -> int:
        """Stencil rows: 3^(dim-1) contiguous runs cover the 3^dim cells."""
        return 3 ** (self.dim - 1)

    @property
    def strides(self) -> tuple[int, ...]:
        """Row-major strides, last axis fastest, each inner non-z axis
        padded by one gap row (stride uses res+1), so that an out-of-grid
        stencil offset lands in empty id space instead of wrapping into the
        next column's cells.  Axis 0 needs no pad, so 2D strides are
        unpadded."""
        s = [1] * self.dim
        for i in range(self.dim - 2, -1, -1):
            pad = 1 if (i + 1) <= self.dim - 2 else 0
            s[i] = s[i + 1] * (self.res[i + 1] + pad)
        return tuple(s)


def make_grid_spec(
    dim: int,
    domain_start: Sequence[float],
    domain_end: Sequence[float],
    support_length: float,
) -> GridSpec:
    res = tuple(
        int(math.ceil((e - s) / support_length))
        for s, e in zip(domain_start, domain_end)
    )
    return GridSpec(
        dim=dim,
        domain_start=tuple(float(v) for v in domain_start),
        domain_end=tuple(float(v) for v in domain_end),
        cell_size=float(support_length),
        res=res,
    )


def cell_coords(x: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """(N, dim) int32 cell coordinates, clipped into the grid so that
    out-of-domain stragglers stay in edge cells."""
    start = device_constant(spec.domain_start, x.dtype, x.device)
    c = torch.floor((x - start) / spec.cell_size).to(torch.int32)
    hi = device_constant([r - 1 for r in spec.res], torch.int32, x.device)
    return torch.minimum(torch.clamp(c, min=0), hi)


def flat_cell_ids(coords: torch.Tensor, material: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """(N,) int32 flat ids; inactive slots get the sentinel ``num_cells``
    so a stable sort puts them at the tail."""
    strides = device_constant(spec.strides, torch.int32, coords.device)
    ids = torch.sum(coords * strides, dim=-1, dtype=torch.int32)
    return torch.where(material == MATERIAL_INVALID,
                       torch.full_like(ids, spec.num_cells), ids)


def coords_from_ids(ids: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Inverse of :func:`flat_cell_ids` for real cells: (N, dim) int32
    coordinates decoded from flat ids."""
    cols = []
    rem = ids
    for s in spec.strides[:-1]:
        cols.append(torch.div(rem, s, rounding_mode="floor"))
        rem = torch.remainder(rem, s)
    cols.append(rem)
    return torch.stack(cols, dim=-1).to(torch.int32)


def sort_state_by_cell(
    state: SimState, spec: GridSpec
) -> tuple[SimState, torch.Tensor, torch.Tensor]:
    """Reorder every particle field by cell id with a stable sort.

    Returns (sorted_state, sorted_ids, perm), perm int64.  The sorted state
    holds fresh tensors, so nothing the caller holds is aliased.
    """
    sorted_ids, perm = cell_sort(state.x, state.material, spec)
    return gather_state(state, perm), sorted_ids, perm


def cell_sort(x: torch.Tensor, material: torch.Tensor, spec: GridSpec
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted_ids, perm): the rows' flat cell ids sorted stably, (N,)
    int32, and the sort's permutation, (N,) int64.  The plain version of
    the small-state front kernel (``ops.cuda.bounds.cell_sort``)."""
    ids = flat_cell_ids(cell_coords(x, spec), material, spec)
    return torch.sort(ids, stable=True)


def state_fields(state: SimState) -> list[str]:
    """Names of the state's per-particle tensor fields, in field order."""
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def gather_state(state: SimState, perm: torch.Tensor) -> SimState:
    """Every per-particle field reordered by ``perm`` (row k of the result
    is row perm[k]): one ``index_select`` per field, the plain version of
    the rebuild kernel's gather (``ops.cuda.bounds``)."""
    return dataclasses.replace(state, **{
        name: getattr(state, name).index_select(0, perm) for name in state_fields(state)})


def csr_bounds(sorted_ids: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """bounds[c] = first sorted index with cell id >= c, c in [0,
    num_cells]; the particles of cell c are sorted[bounds[c]:bounds[c+1]].

    The plain version of the bounds kernel (``ops.cuda.bounds``), by
    ``torch.searchsorted``; the ids must be sorted, inactive tail =
    ``num_cells``."""
    queries = torch.arange(spec.num_cells + 1, dtype=sorted_ids.dtype,
                           device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, queries, side="left", out_int32=True)


def _row_offsets(spec: GridSpec) -> np.ndarray:
    """(num_rows, dim-1) stencil row offsets in {-1, 0, 1}."""
    grids = np.meshgrid(*([np.arange(-1, 2, dtype=np.int32)] * (spec.dim - 1)),
                        indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def stencil_runs(coords: torch.Tensor, bounds: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """(N, num_rows, 2) int32 [start, end) runs of the sorted array.

    For a particle in cell (c_0..c_{d-1}) and row offset o, the run covers
    cells (c+o, z) for z in [c_{d-1}-1, c_{d-1}+1] clipped to the grid.
    Rows outside the grid give empty runs [s, s) at the nearest valid cell.
    """
    res = np.asarray(spec.res)
    strides = np.asarray(spec.strides)
    dev = coords.device
    lead = coords[:, : spec.dim - 1]
    z = coords[:, spec.dim - 1]
    z_lo = torch.clamp(z - 1, min=0)
    z_hi = torch.clamp(z + 1, max=int(res[-1]) - 1)
    res_lead = device_constant(res[:-1].tolist(), torch.int32, dev)
    strides_lead = device_constant(strides[:-1].tolist(), torch.int32, dev)

    runs = []
    for o in _row_offsets(spec):
        nb = lead + device_constant(o.tolist(), torch.int32, dev)
        valid = torch.all((nb >= 0) & (nb < res_lead), dim=-1)
        nb_cl = torch.minimum(torch.clamp(nb, min=0), res_lead - 1)
        base = torch.sum(nb_cl * strides_lead, dim=-1, dtype=torch.int32)
        start = bounds[torch.clamp(base + z_lo, 0, spec.num_cells).long()]
        end = torch.where(
            valid, bounds[torch.clamp(base + z_hi + 1, 0, spec.num_cells).long()], start
        )
        runs.append(torch.stack([start, end], dim=-1))
    return torch.stack(runs, dim=1)


def _row_queries(coords: torch.Tensor, spec: GridSpec, lo_off: int, hi_off: int):
    """Per-particle inclusive stencil-row cell-id ranges, (N, num_rows)
    each; rows whose lead coordinates leave the grid get (lo_off, hi_off)."""
    res = np.asarray(spec.res)
    dev = coords.device
    lead = coords[:, : spec.dim - 1]
    z = coords[:, spec.dim - 1]
    z_lo = torch.clamp(z - 1, min=0)
    z_hi = torch.clamp(z + 1, max=int(res[-1]) - 1)
    res_lead = device_constant(res[:-1].tolist(), torch.int32, dev)
    strides_lead = device_constant(spec.strides[:-1], torch.int32, dev)
    lo, hi = [], []
    for o in _row_offsets(spec):
        nb = lead + device_constant(o.tolist(), torch.int32, dev)
        valid = torch.all((nb >= 0) & (nb < res_lead), dim=-1)
        base = torch.sum(nb * strides_lead, dim=-1, dtype=torch.int32)
        lo.append(torch.where(valid, base + z_lo, lo_off))
        hi.append(torch.where(valid, base + z_hi, hi_off))
    return torch.stack(lo, dim=1), torch.stack(hi, dim=1)


def cell_target_ranges(coords: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """(N, num_rows, 2) int32 inclusive [c_lo, c_hi] cell-id ranges: j is a
    stencil candidate of i in row r iff c_lo <= id_j <= c_hi.  Rows outside
    the grid get the empty range [0, -1]."""
    lo, hi = _row_queries(coords, spec, 0, -1)
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def block_window_bounds(
    sorted_ids: torch.Tensor,
    coords: torch.Tensor,
    spec: GridSpec,
    block_size: int,
    ids_i: torch.Tensor | None = None,
    bounds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(block, row) candidate windows [start, end) of the linear layout,
    each (num_blocks, num_rows) int32, in j-array (sorted) coordinates.

    A block is ``block_size`` consecutive rows of the i side (``coords``,
    with ids ``ids_i``; by default the first rows of ``sorted_ids``).  Its
    window in row r runs from the first j with id >= min c_lo to past the
    last j with id <= max c_hi, the extremes over the block's active rows
    whose stencil row stays in the grid (an empty block gives start >=
    end).  With ``bounds`` (the CSR bounds of ``sorted_ids``) the two ends
    are read out of it, bounds[min c_lo] and bounds[max c_hi + 1], instead
    of two searchsorteds: the same numbers.
    """
    n = coords.shape[0]
    nc = spec.num_cells
    num_blocks = -(-n // block_size)
    q_lo, q_hi = _row_queries(coords, spec, nc, -1)
    if ids_i is None:
        ids_i = sorted_ids[:n]
    inactive = (ids_i >= nc)[:, None]
    q_lo = torch.where(inactive, nc, q_lo)
    q_hi = torch.where(inactive, -1, q_hi)
    pad = num_blocks * block_size - n
    if pad:
        q_lo = torch.cat([q_lo, q_lo.new_full((pad, spec.num_rows), nc)])
        q_hi = torch.cat([q_hi, q_hi.new_full((pad, spec.num_rows), -1)])
    lo_min = q_lo.reshape(num_blocks, block_size, -1).amin(dim=1)
    hi_max = q_hi.reshape(num_blocks, block_size, -1).amax(dim=1)
    if bounds is not None:
        return bounds[lo_min.long()], bounds[(hi_max + 1).long()]
    starts = torch.searchsorted(sorted_ids, lo_min.to(sorted_ids.dtype).contiguous())
    ends = torch.searchsorted(sorted_ids, (hi_max + 1).to(sorted_ids.dtype).contiguous())
    return starts.to(torch.int32), ends.to(torch.int32)
