"""The legacy (V1) solver's pair sums: the CUDA kernel ``csrc/legacy.cu``
and its dispatch, one wrapper per mode.

No TPU kernel stands behind them (``tisph_tpu`` runs them as jnp sweeps,
``tisph_tpu/models/wcsph_legacy.py:50-93``).  The plain versions are the
functions of the same names in ``ops.neighbors``, with the same signatures
and packs: a CPU tensor goes there, a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.

How many threads of the kernel share a row is a launch rule of the row
count and the dim (``legacy_launch_shape``), decided on the host, so
a captured graph records one fixed launch and the graph path stays bitwise
the eager loop.  ``_launch`` takes the lane count itself, so that the
card's checks and timings can hold every built count against the plain
version; a count the kernel is not built for raises.
"""

from __future__ import annotations

import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.cuda.sweeps import _check, _grid_args, _ptr
from tisph_tpu_torch.ops.grid import GridSpec
from tisph_tpu_torch.ops.kernels import cubic_kernel_sigma

_MODES = {"density": 0, "force": 1}
_THREADS = 128  # per CTA, whatever the lanes per row
LANES = (4, 16)  # the lane counts csrc/legacy.cu is built for
# (rows below, lanes) of the rule, by dim, in increasing rows, the last
# bound int32's.  Timed on an H100 at 4 and 16 lanes (PERF.md section 6,
# ``kernel_times --legacy``), both modes: in 2D 16 lanes win or tie up to
# 25,200 rows and lose at 50,400; in 3D they win up to 50,224 and lose at
# 100,800 (3D rows walk 9 stencil runs, 2D rows 3, so more lanes pay to
# more rows).  The rule switches near the geometric mean of each bracket.
LANE_RULE = {
    2: ((36_000, 16), (2**31 - 1, 4)),
    3: ((72_000, 16), (2**31 - 1, 4)),
}


def legacy_launch_shape(dim: int, n: int) -> tuple[int, int]:
    """(threads per row, CTAs) of ``csrc/legacy.cu``'s launch on ``n``
    rows of a ``dim``-D scene, either mode: a row's lanes split its
    candidates and add their partial sums in a fixed order, more lanes the
    fewer the rows."""
    lanes = next(L for below, L in LANE_RULE[dim] if n < below)
    return lanes, -(-n // (_THREADS // lanes))


def _launch(mode: str, lanes: int, pos, vel, aux, ids, bounds, material, spec: GridSpec,
            params: SolverParams) -> torch.Tensor:
    """One launch of ``mode`` at ``lanes`` threads a row, uncounted; on a
    CUDA tensor only."""
    name = f"legacy_{mode}_sweep"
    if ids.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ids.device}")
    force = mode == "force"
    _check(name, spec, ids, bounds, material,
           {"pos": pos} | ({"vel": vel, "aux": aux} if force else {}))
    dim, h, n = spec.dim, params.support_length, ids.shape[0]
    k_sig = cubic_kernel_sigma(dim, h)
    m_v, mass = neighbors.legacy_masses(params)
    out = torch.empty((n, dim) if force else (n,), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        err = build.load().tisph_legacy_sweep(
            _MODES[mode], dim, lanes, pos.data_ptr(), _ptr(vel), _ptr(aux), ids.data_ptr(),
            bounds.data_ptr(), material.data_ptr(), out.data_ptr(), n, *_grid_args(spec),
            h, h * h, k_sig, m_v, 2.0 * (dim + 2) * params.viscosity, mass, 0.01 * h * h,
            params.density0 * m_v,
            params.density0, -9.80,
            # read at every call: the capture stream under torch.cuda.graph
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, f"{name} (lanes={lanes})")
    return out


def legacy_density_sweep(pos, ids, bounds, material, spec: GridSpec,
                         params: SolverParams) -> torch.Tensor:
    """(N,) density on fluid rows, 0 elsewhere
    (``neighbors.legacy_density_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.legacy_density_sweep(pos, ids, bounds, material, spec, params)
    lanes, _ = legacy_launch_shape(spec.dim, ids.shape[0])
    out = _launch("density", lanes, pos, None, None, ids, bounds, material, spec, params)
    legacy_density_sweep.launches += 1
    return out


def legacy_force_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                       params: SolverParams) -> torch.Tensor:
    """(N, dim) acceleration on fluid rows, 0 elsewhere
    (``neighbors.legacy_force_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.legacy_force_sweep(pos, vel, aux, ids, bounds, material, spec, params)
    lanes, _ = legacy_launch_shape(spec.dim, ids.shape[0])
    out = _launch("force", lanes, pos, vel, aux, ids, bounds, material, spec, params)
    legacy_force_sweep.launches += 1
    return out


legacy_density_sweep.launches = 0
legacy_force_sweep.launches = 0
