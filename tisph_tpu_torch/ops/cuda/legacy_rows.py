"""The legacy (V1) step's per-particle row ops: the CUDA kernels
``csrc/legacy_rows.cu`` and their dispatch, one wrapper per pass.

- ``legacy_pos_pack``, after the rebuild: the two sums' ``[x, fl]`` pack;
- ``legacy_eos_pack``, between the sums: the density kept on fluid rows,
  the Tait EOS and the force sum's packs;
- ``legacy_advance``, after the force sum: symplectic Euler and, unless
  ``reference_exact``, the per-axis domain clamp.

No TPU kernel stands behind them: ``tisph_tpu`` runs this math as row ops
inside its legacy step's jit (``tisph_tpu/models/wcsph_legacy.py``).  The
plain versions are ``ops.neighbors.legacy_pos``,
``ops.forces.legacy_eos_pack_plain`` and ``legacy_advance_plain``, with
the same signatures: a CPU tensor goes there, a CUDA tensor launches the
kernel or raises.  On the card the outputs are bitwise the plain
versions', NaN rows included.  Each wrapper launches through
``build.launch`` (the current stream, read at every call, and
``launches.<wrapper>`` in ``utils.profiling``'s registry) and returns
fresh tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops import forces, neighbors
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.eos import integer_exponent


def legacy_pos_pack(state: SimState) -> torch.Tensor:
    """(N, 4) ``[x, fl]`` of a sorted state, fl 1 on fluid rows, else 0
    (``neighbors.legacy_pos``)."""
    if state.x.device.type == "cpu":
        return neighbors.legacy_pos(state)
    n, dim = state.x.shape
    build.check_tensors("legacy_pos_pack", n, dim, {
        "x": (state.x, torch.float32, (n, dim)),
        "material": (state.material, torch.int32, (n,))})
    pos = torch.empty((n, 4), dtype=torch.float32, device=state.x.device)
    build.launch("legacy_pos_pack", "tisph_legacy_pos_pack", pos.device,
                 dim, n, state.x.data_ptr(), state.material.data_ptr(), pos.data_ptr())
    return pos


def legacy_eos_pack(acc: torch.Tensor, state: SimState,
                    params: SolverParams) -> tuple[torch.Tensor, ...]:
    """``(rho, pressure, vel, aux)``: the density sum ``acc`` kept on fluid
    rows, the Tait EOS, and the force sum's packs
    (``forces.legacy_eos_pack_plain``)."""
    if acc.device.type == "cpu":
        return forces.legacy_eos_pack_plain(acc, state, params)
    n, dim = state.v.shape
    f32 = torch.float32
    build.check_tensors("legacy_eos_pack", n, dim, {
        "acc": (acc, f32, (n,)), "density": (state.density, f32, (n,)),
        "material": (state.material, torch.int32, (n,)), "volume": (state.volume, f32, (n,)),
        "v": (state.v, f32, (n, dim))})
    rho0 = np.float32(params.density0)
    rho = torch.empty_like(acc)
    pressure = torch.empty_like(acc)
    vel = torch.empty((n, 4), dtype=f32, device=acc.device)
    aux = torch.empty((n, 4), dtype=f32, device=acc.device)
    build.launch("legacy_eos_pack", "tisph_legacy_eos_pack", acc.device,
                 dim, n, acc.data_ptr(), state.density.data_ptr(), state.material.data_ptr(),
                 state.volume.data_ptr(), state.v.data_ptr(), rho.data_ptr(), pressure.data_ptr(),
                 vel.data_ptr(), aux.data_ptr(), float(rho0), float(np.float32(1.0) / rho0),
                 params.stiffness, params.exponent, integer_exponent(params.exponent))
    return rho, pressure, vel, aux


def legacy_advance(state: SimState, rho: torch.Tensor, pressure: torch.Tensor,
                   dv: torch.Tensor, params: SolverParams) -> SimState:
    """The legacy step's end: ``state`` with density ``rho`` and
    ``pressure``, its fluid rows advected by ``dv`` and, unless
    ``reference_exact``, clamped per axis (``forces.legacy_advance_plain``)."""
    if dv.device.type == "cpu":
        return forces.legacy_advance_plain(state, rho, pressure, dv, params)
    n, dim = state.x.shape
    f32 = torch.float32
    build.check_tensors("legacy_advance", n, dim, {
        "x": (state.x, f32, (n, dim)), "v": (state.v, f32, (n, dim)),
        "dv": (dv, f32, (n, dim)), "material": (state.material, torch.int32, (n,))})
    lo, hi = forces.box_bounds(params)
    lo, hi = lo + [0.0] * (3 - dim), hi + [0.0] * (3 - dim)
    x = torch.empty_like(state.x)
    v = torch.empty_like(state.v)
    build.launch("legacy_advance", "tisph_legacy_advance", dv.device,
                 dim, n, state.x.data_ptr(), state.v.data_ptr(), dv.data_ptr(),
                 state.material.data_ptr(), x.data_ptr(), v.data_ptr(), params.dt, *lo, *hi,
                 1.0 + params.collision_factor, int(not params.reference_exact))
    return dataclasses.replace(state, x=x, v=v, density=rho, pressure=pressure)
