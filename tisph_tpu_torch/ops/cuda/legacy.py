"""The legacy (V1) solver's pair sums: the CUDA kernel ``csrc/legacy.cu``
and its dispatch, one wrapper per mode.

No TPU kernel stands behind them (``tisph_tpu`` runs them as jnp sweeps,
``tisph_tpu/models/wcsph_legacy.py:50-93``).  The plain versions are the
functions of the same names in ``ops.neighbors``, with the same signatures
and packs: a CPU tensor goes there, a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
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


def _launch(mode: str, pos, vel, aux, ids, bounds, material, spec: GridSpec,
            params: SolverParams) -> torch.Tensor:
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
            _MODES[mode], dim, pos.data_ptr(), _ptr(vel), _ptr(aux), ids.data_ptr(),
            bounds.data_ptr(), material.data_ptr(), out.data_ptr(), n, *_grid_args(spec),
            h, h * h, k_sig, m_v, 2.0 * (dim + 2) * params.viscosity, mass, 0.01 * h * h,
            params.density0 * m_v,
            params.density0, -9.80,
            # read at every call: the capture stream under torch.cuda.graph
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, name)
    return out


def legacy_density_sweep(pos, ids, bounds, material, spec: GridSpec,
                         params: SolverParams) -> torch.Tensor:
    """(N,) density on fluid rows, 0 elsewhere
    (``neighbors.legacy_density_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.legacy_density_sweep(pos, ids, bounds, material, spec, params)
    out = _launch("density", pos, None, None, ids, bounds, material, spec, params)
    legacy_density_sweep.launches += 1
    return out


def legacy_force_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                       params: SolverParams) -> torch.Tensor:
    """(N, dim) acceleration on fluid rows, 0 elsewhere
    (``neighbors.legacy_force_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.legacy_force_sweep(pos, vel, aux, ids, bounds, material, spec, params)
    out = _launch("force", pos, vel, aux, ids, bounds, material, spec, params)
    legacy_force_sweep.launches += 1
    return out


legacy_density_sweep.launches = 0
legacy_force_sweep.launches = 0
