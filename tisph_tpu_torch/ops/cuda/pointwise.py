"""The WCSPH substep's per-particle row ops: the CUDA kernels
``csrc/pointwise.cu`` and their dispatch, one wrapper per pass.

- ``eos_pack``, before the force sweep: the kept density, the density
  mode, the Tait EOS and the force sweep's packs;
- ``advance``, after it: symplectic Euler and the domain-box clamp.

No TPU kernel stands behind them: ``tisph_tpu`` runs this math as row ops
that XLA fuses (``tisph_tpu/models/wcsph.py:255-264`` and ``:283-311``).
The plain versions are ``ops.forces.eos_packs_plain`` and
``advance_plain``, with the same signatures: a CPU tensor goes there, a
CUDA tensor launches the kernel or raises.  On the card the outputs are
bitwise the plain versions', NaN rows included.  Each wrapper counts its
launches in ``<wrapper>.launches``; it reads the current stream at every
call, so a CUDA graph capture records the launch, and returns fresh
tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops import forces
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.eos import integer_exponent
from tisph_tpu_torch.ops.kernels import cubic_kernel_sigma


def _check(name: str, n: int, dim: int, tensors) -> None:
    """Every tensor of ``tensors`` ({key: (tensor, dtype, shape)}) on the
    first one's CUDA device, of its dtype and shape, contiguous."""
    if dim not in (2, 3):
        raise ValueError(f"{name}: dim must be 2 or 3, got {dim}")
    if n >= 2**31 - 1:
        raise ValueError(f"{name}: {n} rows do not fit in int32")
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for key, (t, dtype, shape) in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {key} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, want {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def eos_pack(rho: torch.Tensor, state: SimState, fluid: torch.Tensor, flm: torch.Tensor,
             params: SolverParams) -> tuple[torch.Tensor, ...]:
    """``(rho, pressure, vel, aux)``: the density sweep's ``rho`` kept on
    the sort-time ``fluid`` rows, the density mode on the current fluid
    rows, the Tait EOS, and the force sweep's packs
    (``forces.eos_packs_plain``)."""
    if rho.device.type == "cpu":
        return forces.eos_packs_plain(rho, state, fluid, flm, params)
    n, dim = state.v.shape
    f32 = torch.float32
    _check("eos_pack", n, dim, {
        "rho": (rho, f32, (n,)), "density": (state.density, f32, (n,)),
        "fluid": (fluid, torch.bool, (n,)), "flm": (flm, f32, (n,)),
        "material": (state.material, torch.int32, (n,)), "mass": (state.mass, f32, (n,)),
        "v": (state.v, f32, (n, dim))})
    rho0 = np.float32(params.density0)
    w0 = cubic_kernel_sigma(params.dim, params.support_length)
    rho_out = torch.empty_like(rho)
    p_out = torch.empty_like(rho)
    vel = torch.empty((n, 4), dtype=f32, device=rho.device)
    aux = torch.empty((n, 4), dtype=f32, device=rho.device)
    with torch.cuda.device(rho.device):
        err = build.load().tisph_eos_pack(
            dim, n, rho.data_ptr(), state.density.data_ptr(), fluid.data_ptr(),
            flm.data_ptr(), state.material.data_ptr(), state.mass.data_ptr(),
            state.v.data_ptr(), rho_out.data_ptr(), p_out.data_ptr(), vel.data_ptr(),
            aux.data_ptr(), float(rho0), float(np.float32(1.0) / rho0), params.stiffness,
            params.exponent, integer_exponent(params.exponent), int(params.reference_exact),
            w0,
            # read at every call: the capture stream under torch.cuda.graph
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "eos_pack")
    eos_pack.launches += 1
    return rho_out, p_out, vel, aux


def advance(state: SimState, rho: torch.Tensor, pressure: torch.Tensor, dv: torch.Tensor,
            params: SolverParams) -> SimState:
    """The substep's end: ``state`` with density ``rho`` and ``pressure``,
    its fluid rows advected by ``dv`` and clamped to the domain box
    (``forces.advance_plain``)."""
    if dv.device.type == "cpu":
        return forces.advance_plain(state, rho, pressure, dv, params)
    n, dim = state.x.shape
    f32 = torch.float32
    _check("advance", n, dim, {
        "x": (state.x, f32, (n, dim)), "v": (state.v, f32, (n, dim)),
        "dv": (dv, f32, (n, dim)), "material": (state.material, torch.int32, (n,))})
    lo, hi = forces.box_bounds(params)
    lo, hi = lo + [0.0] * (3 - dim), hi + [0.0] * (3 - dim)
    x = torch.empty_like(state.x)
    v = torch.empty_like(state.v)
    with torch.cuda.device(dv.device):
        err = build.load().tisph_advance(
            dim, n, state.x.data_ptr(), state.v.data_ptr(), dv.data_ptr(),
            state.material.data_ptr(), x.data_ptr(), v.data_ptr(), params.dt, *lo, *hi,
            1.0 + params.collision_factor,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "advance")
    advance.launches += 1
    return dataclasses.replace(state, x=x, v=v, density=rho, pressure=pressure)


eos_pack.launches = 0
advance.launches = 0
