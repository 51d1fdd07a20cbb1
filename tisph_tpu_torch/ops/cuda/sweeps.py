"""WCSPH neighbour sweeps: the CUDA kernels ``csrc/sweeps.cu`` and
``csrc/sweeps_linear.cu`` and their dispatch, one wrapper per mode.

- ``csrc/sweeps.cu`` replaces ``tisph_tpu/ops/pallas/sweeps.py::
  _seg_sweep_kernel`` (launched by ``_run_sweep_seg``, wrapped by
  ``density_sweep_seg``, ``force_sweep_seg``, ``bvol_sweep_seg``,
  ``force_react_sweep_seg`` and ``reaction_sweep_seg``): the wrappers
  ``density_sweep``, ``force_sweep``, ``bvol_sweep``, ``force_react_sweep``
  and ``reaction_sweep``;
- ``csrc/sweeps_linear.cu`` replaces ``_sweep_kernel``, the linear-layout
  sweep (launched by ``_run_sweep``, wrapped by ``density_sweep`` and
  ``force_sweep`` there): the wrappers ``density_sweep_linear`` and
  ``force_sweep_linear``.

The plain versions are the functions of the same names in
``ops.neighbors``, with the same signatures and pack layouts: a CPU tensor
goes there, a CUDA tensor launches the kernel or raises.  Each launch
counts in ``utils.profiling``'s registry (``build.launch``):
``launches.<wrapper>``, of those the ones over part of the arrays in
``part_launches.<wrapper>`` (an i-row map for ``csrc/sweeps.cu``, a row
range for ``csrc/sweeps_linear.cu``), and the rows it swept in
``rows.<wrapper>``.

Every wrapper of ``csrc/sweeps.cu`` takes ``rows``: None sweeps every
row, the launch it always was; ``(row0, n)`` sweeps rows [row0, row0 + n)
of the arrays; an (n,) int32 tensor, an i-row map, sweeps the rows it
lists (row t of the output is row ``rows[t]``).  The candidates lie
anywhere in the arrays and the output has n rows.  The slab solver sweeps
a shard's rows of its halo window by a range (``tisph_tpu`` sweeps the
whole extended array and slices the shard's rows out,
``parallel/domain.py:559``, ``:624-628``); the rectangle solver its own
rows of the id-merged extended array by a map (``tisph_tpu`` passes them
as a separate i pack, ``ipack``, ``ops/pallas/sweeps.py:1166-1182``).
The wrappers of ``csrc/sweeps_linear.cu`` take ``rows=(row0, n)``: blocks
of 128 rows from row0 on (the sharded linear step, ``tisph_tpu``'s
``ipack`` slice of its extended pack, ``parallel/domain.py:940-942``).

How many threads of ``csrc/sweeps.cu`` share a row is a launch rule of
the swept row count (``launch_shape``), read by no caller but the launch: a
small launch gives a row 4 or 8 lanes (and the gradient modes the
two-stage walk), a large one one thread, whose sums are in j order.
Either way the same input gives bitwise the same output.
"""

from __future__ import annotations

import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.grid import GridSpec
from tisph_tpu_torch.ops.kernels import cubic_kernel_sigma

_MODES = {"density": 0, "force": 1, "bvol": 2, "force_react": 3, "reaction": 4}
_LINEAR_MODES = {"density": 0, "force": 1}  # csrc/sweeps_linear.cu
_GRAD = ("force", "force_react", "reaction")  # read vel and aux, write (N, dim)


def _check(name: str, spec: GridSpec, ids, bounds, material, packs) -> None:
    """A sweep's tensors (``build.check_tensors``), ids first: on their CUDA
    device, the grid's cells in int32, and ``packs`` {key: (N, 4) f32}."""
    n = ids.shape[0]
    if spec.num_cells >= 2**31 - 1:
        raise ValueError(f"{name}: sizes must fit in int32")
    build.check_tensors(name, n, spec.dim, {
        "ids": (ids, torch.int32, (n,)),
        "bounds": (bounds, torch.int32, (spec.num_cells + 1,)),
        "material": (material, torch.int32, (n,)),
        **{k: (t, torch.float32, (n, 4)) for k, t in packs.items()}})


def _grid_args(spec: GridSpec) -> tuple[int, ...]:
    """res0, res1, res_z, s0, s1 of the kernels' GridArgs (axis 1: 0 in 2D)."""
    res, strides, d3 = spec.res, spec.strides, spec.dim == 3
    return res[0], res[1] if d3 else 0, res[-1], strides[0], strides[1] if d3 else 0


def _phys_args(grad: bool, spec: GridSpec, params: SolverParams) -> tuple[float, ...]:
    """The kernels' PhysArgs: 1/h, the finaliser k_sig (k_sig / h for the
    gradient modes), 0.01 h^2, 2 nu h c_s, sigma_b h c_s, h sigma_st, g."""
    h = params.support_length
    k_sig = cubic_kernel_sigma(spec.dim, h)
    g = tuple(params.gravity) + (0.0,) * (3 - spec.dim)
    return (1.0 / h, k_sig / h if grad else k_sig, 0.01 * h * h,
            2.0 * params.viscosity * h * params.c_s, params.boundary_sigma * h * params.c_s,
            h * params.surface_tension, *g)


_THREADS = 128  # per CTA of csrc/sweeps.cu, whatever the lanes per row
# (rows below, threads per row) of csrc/sweeps.cu, by mode; one thread per
# row from that many rows up, where the rows alone fill the SMs.  Measured
# on an H100 at 60,864 to 1,000,000 rows (csrc/sweeps.cu's header; PERF.md):
# the gradient modes' two-stage walk stops paying on a dense lattice
# between 220,000 and 350,000 rows, density's lanes between 500,000 and
# 740,000.  bvol and reaction sum on boundary rows only, a small share of
# most launches.
_LANES = {
    "density": (600_000, 4),
    "force": (300_000, 4),
    "bvol": (600_000, 8),
    "force_react": (300_000, 4),
    "reaction": (300_000, 8),
}


def launch_shape(mode: str, n: int) -> tuple[int, int]:
    """(threads per row, CTAs) of the seg sweep kernel's launch on ``n``
    rows in ``mode``: small launches give a row several lanes, which share
    its candidates and add their partial sums in a fixed order (and, in the
    gradient modes, queue the pairs inside h); with one thread per row the
    sums are in j order."""
    below, lanes = _LANES[mode]
    if n >= below:
        lanes = 1
    return lanes, -(-n // (_THREADS // lanes))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(mode: str, pos, vel, aux, ids, bounds, material,
            spec: GridSpec, params: SolverParams, fast_math: bool, rows) -> torch.Tensor:
    name = f"{mode}_sweep"
    packs = {"pos": pos} | ({"vel": vel, "aux": aux} if mode in _GRAD else {})
    _check(name, spec, ids, bounds, material, packs)
    irows = None
    if isinstance(rows, torch.Tensor):
        neighbors.check_row_map(rows, ids, name)
        irows, row0, n = rows, 0, rows.shape[0]
    else:
        row0, n = neighbors.row_range(rows, ids.shape[0], name)
    dim = spec.dim
    out = torch.empty((n, dim) if mode in _GRAD else (n,),
                      dtype=torch.float32, device=ids.device)
    build.launch(name, "tisph_sweep", ids.device,
                 _MODES[mode], dim, int(fast_math), launch_shape(mode, n)[0], pos.data_ptr(),
                 _ptr(vel), _ptr(aux), ids.data_ptr(), bounds.data_ptr(), material.data_ptr(),
                 _ptr(irows), out.data_ptr(), row0, n, ids.shape[0],
                 *_grid_args(spec), *_phys_args(mode in _GRAD, spec, params),
                 part_launches=int(irows is not None), rows=n)
    return out


def _launch_linear(mode: str, pos, vel, aux, ids, bounds, material, spec: GridSpec,
                   params: SolverParams, fast_math: bool, windows, rows) -> torch.Tensor:
    name = f"{mode}_sweep_linear"
    grad = mode == "force"
    _check(name, spec, ids, bounds, material,
           {"pos": pos} | ({"vel": vel, "aux": aux} if grad else {}))
    if isinstance(rows, torch.Tensor):
        raise ValueError(f"{name}: takes a row range, not an i-row map")
    row0, n = neighbors.row_range(rows, ids.shape[0], name)
    dim = spec.dim
    if ids.shape[0] * spec.num_rows >= 2**31:  # a block's windows as one stream of positions
        raise ValueError(f"{name}: {ids.shape[0]} rows x {spec.num_rows} stencil rows must fit "
                         "in int32")
    if windows is not None:
        shape = (-(-n // neighbors.LINEAR_BLOCK), spec.num_rows, 2)
        if (windows.device != ids.device or windows.dtype != torch.int32
                or tuple(windows.shape) != shape or not windows.is_contiguous()):
            raise ValueError(f"{name}: windows must be a contiguous {shape} int32 tensor "
                             f"on {ids.device}")
    out = torch.empty((n, dim) if grad else (n,), dtype=torch.float32, device=ids.device)
    build.launch(name, "tisph_linear_sweep", ids.device,
                 _LINEAR_MODES[mode], dim, int(fast_math), pos.data_ptr(), _ptr(vel), _ptr(aux),
                 ids.data_ptr(), bounds.data_ptr(), material.data_ptr(), out.data_ptr(),
                 _ptr(windows), row0, n, *_grid_args(spec), spec.num_cells,
                 *_phys_args(grad, spec, params),
                 part_launches=int(rows is not None), rows=n)
    return out


def density_sweep(pos, ids, bounds, material, spec: GridSpec,
                  params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N,) density on fluid rows, 0 elsewhere (``neighbors.density_sweep``).
    ``rows``: None, ``(row0, n)`` or an (n,) int32 i-row map (see the
    module), as in every wrapper of this kernel."""
    if ids.device.type == "cpu":
        return neighbors.density_sweep(pos, ids, bounds, material, spec, params, fast_math,
                                       rows)
    return _launch("density", pos, None, None, ids, bounds, material, spec, params, fast_math,
                   rows)


def bvol_sweep(pos, ids, bounds, material, spec: GridSpec,
               params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N,) boundary-volume denominator on boundary rows, 0 elsewhere
    (``neighbors.bvol_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.bvol_sweep(pos, ids, bounds, material, spec, params, fast_math, rows)
    return _launch("bvol", pos, None, None, ids, bounds, material, spec, params, fast_math,
                   rows)


def force_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N, dim) acceleration on fluid rows, 0 elsewhere
    (``neighbors.force_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.force_sweep(pos, vel, aux, ids, bounds, material, spec,
                                     params, fast_math, rows)
    return _launch("force", pos, vel, aux, ids, bounds, material, spec, params, fast_math,
                   rows)


def force_react_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                      params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N, dim): acceleration on fluid rows, fluid -> boundary reaction
    force on boundary rows, 0 elsewhere (``neighbors.force_react_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.force_react_sweep(pos, vel, aux, ids, bounds, material, spec,
                                           params, fast_math, rows)
    return _launch("force_react", pos, vel, aux, ids, bounds, material, spec, params,
                   fast_math, rows)


def reaction_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                   params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N, dim) fluid -> boundary reaction force on boundary rows, 0
    elsewhere (``neighbors.reaction_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.reaction_sweep(pos, vel, aux, ids, bounds, material, spec,
                                        params, fast_math, rows)
    return _launch("reaction", pos, vel, aux, ids, bounds, material, spec, params, fast_math,
                   rows)


def density_sweep_linear(pos, ids, bounds, material, spec: GridSpec, params: SolverParams,
                         fast_math: bool = True, windows: torch.Tensor | None = None,
                         rows=None) -> torch.Tensor:
    """(N,) density on fluid rows, 0 elsewhere, over the linear layout
    (``neighbors.density_sweep_linear``).  ``windows``: on the card only,
    an optional (ceil(n / 128), num_rows, 2) int32 tensor that receives
    each block's windows [start, end).  ``rows=(row0, n)``: sweep those
    rows in blocks of 128 from row0 on, output (n,); None is every row."""
    if ids.device.type == "cpu":
        if windows is not None:
            raise ValueError("density_sweep_linear: windows are written by the kernel only")
        return neighbors.density_sweep_linear(pos, ids, bounds, material, spec, params,
                                              fast_math, rows)
    return _launch_linear("density", pos, None, None, ids, bounds, material, spec, params,
                           fast_math, windows, rows)


def force_sweep_linear(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                       params: SolverParams, fast_math: bool = True,
                       windows: torch.Tensor | None = None, rows=None) -> torch.Tensor:
    """(N, dim) acceleration on fluid rows, 0 elsewhere, over the linear
    layout (``neighbors.force_sweep_linear``); ``windows`` and ``rows`` as
    in :func:`density_sweep_linear`."""
    if ids.device.type == "cpu":
        if windows is not None:
            raise ValueError("force_sweep_linear: windows are written by the kernel only")
        return neighbors.force_sweep_linear(pos, vel, aux, ids, bounds, material, spec,
                                            params, fast_math, rows)
    return _launch_linear("force", pos, vel, aux, ids, bounds, material, spec, params,
                           fast_math, windows, rows)

