"""WCSPH neighbour sweeps: the CUDA kernel ``csrc/sweeps.cu`` and its
dispatch, one wrapper per mode.

Replaces ``tisph_tpu/ops/pallas/sweeps.py::_seg_sweep_kernel`` (launched
by ``_run_sweep_seg``, wrapped by ``density_sweep_seg``,
``force_sweep_seg``, ``bvol_sweep_seg``, ``force_react_sweep_seg`` and
``reaction_sweep_seg``).  The plain versions are the functions of the same
names in ``ops.neighbors``, with the same signatures and pack layouts: a
CPU tensor goes there, a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.grid import GridSpec
from tisph_tpu_torch.ops.kernels import cubic_kernel_sigma

_MODES = {"density": 0, "force": 1, "bvol": 2, "force_react": 3, "reaction": 4}
_GRAD = ("force", "force_react", "reaction")  # read vel and aux, write (N, dim)


def _check(name: str, spec: GridSpec, ids, bounds, material, packs) -> None:
    dev = ids.device
    n = ids.shape[0]
    if n >= 2**31 - 1 or spec.num_cells >= 2**31 - 1:
        raise ValueError(f"{name}: sizes must fit in int32")
    wants = [("ids", ids, torch.int32, (n,)),
             ("bounds", bounds, torch.int32, (spec.num_cells + 1,)),
             ("material", material, torch.int32, (n,))]
    wants += [(k, t, torch.float32, (n, 4)) for k, t in packs.items()]
    for key, t, dtype, shape in wants:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {key} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, ids on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if spec.dim not in (2, 3):
        raise ValueError(f"{name}: dim must be 2 or 3, got {spec.dim}")


def _launch(mode: str, pos, vel, aux, ids, bounds, material,
            spec: GridSpec, params: SolverParams, fast_math: bool) -> torch.Tensor:
    name = f"{mode}_sweep"
    if ids.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ids.device}")
    packs = {"pos": pos} | ({"vel": vel, "aux": aux} if mode in _GRAD else {})
    _check(name, spec, ids, bounds, material, packs)
    n, dim = ids.shape[0], spec.dim
    out = torch.empty((n, dim) if mode in _GRAD else (n,),
                      dtype=torch.float32, device=ids.device)
    h = params.support_length
    k_sig = cubic_kernel_sigma(dim, h)
    res, strides = spec.res, spec.strides
    g = tuple(params.gravity) + (0.0,) * (3 - dim)
    with torch.cuda.device(ids.device):
        err = build.load().tisph_sweep(
            _MODES[mode], dim, int(fast_math),
            pos.data_ptr(),
            vel.data_ptr() if vel is not None else None,
            aux.data_ptr() if aux is not None else None,
            ids.data_ptr(), bounds.data_ptr(), material.data_ptr(), out.data_ptr(),
            n,
            res[0], res[1] if dim == 3 else 0, res[-1],
            strides[0], strides[1] if dim == 3 else 0,
            1.0 / h,
            k_sig / h if mode in _GRAD else k_sig,
            0.01 * h * h,
            2.0 * params.viscosity * h * params.c_s,
            params.boundary_sigma * h * params.c_s,
            h * params.surface_tension,
            *g,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, name)
    return out


def density_sweep(pos, ids, bounds, material, spec: GridSpec,
                  params: SolverParams, fast_math: bool = True) -> torch.Tensor:
    """(N,) density on fluid rows, 0 elsewhere (``neighbors.density_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.density_sweep(pos, ids, bounds, material, spec, params, fast_math)
    out = _launch("density", pos, None, None, ids, bounds, material, spec, params, fast_math)
    density_sweep.launches += 1
    return out


def bvol_sweep(pos, ids, bounds, material, spec: GridSpec,
               params: SolverParams, fast_math: bool = True) -> torch.Tensor:
    """(N,) boundary-volume denominator on boundary rows, 0 elsewhere
    (``neighbors.bvol_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.bvol_sweep(pos, ids, bounds, material, spec, params, fast_math)
    out = _launch("bvol", pos, None, None, ids, bounds, material, spec, params, fast_math)
    bvol_sweep.launches += 1
    return out


def force_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                params: SolverParams, fast_math: bool = True) -> torch.Tensor:
    """(N, dim) acceleration on fluid rows, 0 elsewhere
    (``neighbors.force_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.force_sweep(pos, vel, aux, ids, bounds, material, spec,
                                     params, fast_math)
    out = _launch("force", pos, vel, aux, ids, bounds, material, spec, params, fast_math)
    force_sweep.launches += 1
    return out


def force_react_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                      params: SolverParams, fast_math: bool = True) -> torch.Tensor:
    """(N, dim): acceleration on fluid rows, fluid -> boundary reaction
    force on boundary rows, 0 elsewhere (``neighbors.force_react_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.force_react_sweep(pos, vel, aux, ids, bounds, material, spec,
                                           params, fast_math)
    out = _launch("force_react", pos, vel, aux, ids, bounds, material, spec, params,
                  fast_math)
    force_react_sweep.launches += 1
    return out


def reaction_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                   params: SolverParams, fast_math: bool = True) -> torch.Tensor:
    """(N, dim) fluid -> boundary reaction force on boundary rows, 0
    elsewhere (``neighbors.reaction_sweep``)."""
    if ids.device.type == "cpu":
        return neighbors.reaction_sweep(pos, vel, aux, ids, bounds, material, spec,
                                        params, fast_math)
    out = _launch("reaction", pos, vel, aux, ids, bounds, material, spec, params, fast_math)
    reaction_sweep.launches += 1
    return out


density_sweep.launches = 0
bvol_sweep.launches = 0
force_sweep.launches = 0
force_react_sweep.launches = 0
reaction_sweep.launches = 0
