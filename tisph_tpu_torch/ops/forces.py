"""Per-particle WCSPH phases: EOS, the reference-exact density mode,
symplectic Euler and the domain-box clamp (``tisph_tpu.ops.forces``
lines 277-365, and the f32 bound arithmetic of its seg step).

:func:`eos_packs_plain` and :func:`advance_plain` chain them as a substep
does around its force sweep; they are the plain versions of the kernels
``csrc/pointwise.cu`` (``ops.cuda.pointwise``).  The legacy (V1) step's
:func:`legacy_eos_pack_plain` and :func:`legacy_advance_plain` are those of
``csrc/legacy_rows.cu`` (``ops.cuda.legacy_rows``).

The pair sums live in ``ops.neighbors`` (plain versions) and
``ops.cuda.sweeps`` (the kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops.consts import device_constant
from tisph_tpu_torch.ops.eos import tait_pressure
from tisph_tpu_torch.ops.kernels import cubic_kernel_sigma
from tisph_tpu_torch.ops.neighbors import legacy_force_packs, pack4, pack_aux


def compute_pressures(
    density: torch.Tensor, params: SolverParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp + Tait EOS for all particles; returns (density, pressure)."""
    return tait_pressure(density, params.density0, params.stiffness, params.exponent)


def apply_density_mode(
    rho: torch.Tensor, state: SimState, params: SolverParams
) -> torch.Tensor:
    """``reference_exact``: the reference's V2 solver overwrites the
    summed fluid density with the self term m_i W(0) (wcsphv2.py:29-34);
    otherwise ``rho`` is returned unchanged."""
    if not params.reference_exact:
        return rho
    w0 = cubic_kernel_sigma(params.dim, params.support_length)
    return torch.where(state.fluid_mask, state.mass * w0, rho)


def advect(state: SimState, d_velocity: torch.Tensor, params: SolverParams) -> SimState:
    """Symplectic Euler on fluid particles (wcsphv2.py:95-100)."""
    fluid = state.fluid_mask[:, None]
    v = torch.where(fluid, state.v + params.dt * d_velocity, state.v)
    x = torch.where(fluid, state.x + params.dt * v, state.x)
    return dataclasses.replace(state, x=x, v=v)


def box_bounds(params: SolverParams) -> tuple[list[float], list[float]]:
    """Clamp bounds [start + padding, end - padding] in f32 arithmetic, as
    ``tisph_tpu`` forms them (an f64 sum moves a bound by one ulp)."""
    pad = np.float32(params.padding)
    return ([float(np.float32(s) + pad) for s in params.domain_start],
            [float(np.float32(e) - pad) for e in params.domain_end])


def domain_box(params: SolverParams, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`box_bounds` as f32 tensors, made once per device
    (``ops.consts``)."""
    lo, hi = box_bounds(params)
    return (device_constant(lo, torch.float32, device),
            device_constant(hi, torch.float32, device))


def enforce_domain_boundary(state: SimState, params: SolverParams) -> SimState:
    """Domain-box clamp with a combined collision normal
    (sph_basev2.py:158-189): fluid particles are clamped into the box and
    their velocity reflected, v -= (1 + c_f) (v . n) n, each axis on its own
    coordinate."""
    lo, hi = domain_box(params, state.device)
    fluid = state.fluid_mask[:, None]
    one = torch.ones((), dtype=state.x.dtype, device=state.device)
    zero = torch.zeros((), dtype=state.x.dtype, device=state.device)

    normal = torch.where(state.x > hi, one, zero) + torch.where(state.x <= lo, -one, zero)
    x = torch.where(fluid, torch.clamp(state.x, min=lo, max=hi), state.x)

    n_len = torch.sqrt(torch.sum(normal * normal, dim=-1, keepdim=True))
    n_hat = normal / torch.clamp(n_len, min=1e-6)
    v_dot_n = torch.sum(state.v * n_hat, dim=-1, keepdim=True)
    v_reflected = state.v - (1.0 + params.collision_factor) * v_dot_n * n_hat
    v = torch.where(fluid & (n_len > 1e-6), v_reflected, state.v)
    return dataclasses.replace(state, x=x, v=v)


def eos_packs_plain(rho: torch.Tensor, state: SimState, fluid: torch.Tensor, flm: torch.Tensor,
                    params: SolverParams) -> tuple[torch.Tensor, ...]:
    """The summed density kept on the sort-time ``fluid`` rows (other rows
    keep their stored one), the density mode, the Tait EOS, and the force
    sweep's packs: ``(rho, pressure, vel, aux)``."""
    rho = torch.where(fluid, rho, state.density)
    rho = apply_density_mode(rho, state, params)
    rho, pressure = compute_pressures(rho, params)
    p_rho2 = pressure / torch.clamp(rho * rho, min=1e-12)
    return rho, pressure, pack4(state.v, rho), pack_aux(p_rho2, flm, state.mass)


def advance_plain(state: SimState, rho: torch.Tensor, pressure: torch.Tensor,
                  dv: torch.Tensor, params: SolverParams) -> SimState:
    """The substep's end: store rho and p, advect fluid rows by ``dv``,
    clamp to the domain box."""
    state = dataclasses.replace(state, density=rho, pressure=pressure)
    state = advect(state, dv, params)  # fluid rows only
    return enforce_domain_boundary(state, params)


def enforce_boundary_v1(state: SimState, params: SolverParams) -> SimState:
    """The legacy (V1) domain clamp, per axis: fluid rows are clamped into
    [start + padding, end - padding] and each violating velocity component
    reflected, v -= (1 + c_f) v."""
    lo, hi = domain_box(params, state.device)
    fluid = state.fluid_mask[:, None]
    out = (state.x < lo) | (state.x > hi)
    x = torch.where(fluid, torch.clamp(state.x, min=lo, max=hi), state.x)
    v = torch.where(fluid & out, state.v - (1.0 + params.collision_factor) * state.v, state.v)
    return dataclasses.replace(state, x=x, v=v)


def legacy_eos_pack_plain(acc: torch.Tensor, state: SimState,
                          params: SolverParams) -> tuple[torch.Tensor, ...]:
    """The legacy step between its sums: the density sum ``acc`` kept on
    fluid rows (other rows keep their stored one), the Tait EOS, and the
    force sum's packs: ``(rho, pressure, vel, aux)``."""
    rho, pressure = compute_pressures(torch.where(state.fluid_mask, acc, state.density), params)
    vel, aux = legacy_force_packs(state, rho, pressure)
    return rho, pressure, vel, aux


def legacy_advance_plain(state: SimState, rho: torch.Tensor, pressure: torch.Tensor,
                         dv: torch.Tensor, params: SolverParams) -> SimState:
    """The legacy step's end: store rho and p, advect fluid rows by ``dv``
    and, unless ``reference_exact`` (the reference's V1 never calls its
    domain clamp), clamp them per axis (:func:`enforce_boundary_v1`)."""
    state = advect(dataclasses.replace(state, density=rho, pressure=pressure), dv, params)
    return state if params.reference_exact else enforce_boundary_v1(state, params)
