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
bitwise the plain versions', NaN rows included.  Each wrapper launches
through ``build.launch`` (the current stream, read at every call, and
``launches.<wrapper>`` in ``utils.profiling``'s registry) and returns
fresh tensors.
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
    build.check_tensors("eos_pack", n, dim, {
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
    build.launch("eos_pack", "tisph_eos_pack", rho.device,
                 dim, n, rho.data_ptr(), state.density.data_ptr(), fluid.data_ptr(),
                 flm.data_ptr(), state.material.data_ptr(), state.mass.data_ptr(),
                 state.v.data_ptr(), rho_out.data_ptr(), p_out.data_ptr(), vel.data_ptr(),
                 aux.data_ptr(), float(rho0), float(np.float32(1.0) / rho0), params.stiffness,
                 params.exponent, integer_exponent(params.exponent), int(params.reference_exact),
                 w0)
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
    build.check_tensors("advance", n, dim, {
        "x": (state.x, f32, (n, dim)), "v": (state.v, f32, (n, dim)),
        "dv": (dv, f32, (n, dim)), "material": (state.material, torch.int32, (n,))})
    lo, hi = forces.box_bounds(params)
    lo, hi = lo + [0.0] * (3 - dim), hi + [0.0] * (3 - dim)
    x = torch.empty_like(state.x)
    v = torch.empty_like(state.v)
    build.launch("advance", "tisph_advance", dv.device,
                 dim, n, state.x.data_ptr(), state.v.data_ptr(), dv.data_ptr(),
                 state.material.data_ptr(), x.data_ptr(), v.data_ptr(), params.dt, *lo, *hi,
                 1.0 + params.collision_factor)
    return dataclasses.replace(state, x=x, v=v, density=rho, pressure=pressure)
