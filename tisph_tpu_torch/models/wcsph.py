"""WCSPH: the flagship solver (the reference's SPHBaseV2 + WCSPHV2).

One R-group, as ``tisph_tpu``'s seg rollout runs it
(``WCSPH._seg_build`` and ``_seg_apply_pack``), without the TPU's pack
and block plan:

- ``_build``, once per group: stable sort by cell, then one launch of the
  rebuild kernel for every field in sorted order and the CSR bounds
  (``ops.cuda.bounds.sort_and_bound``), and the group-constant mass
  coefficients (``_group_cache``);
- ``_apply``, every substep: under ``boundary_mode="per_step"`` the bvol
  sweep on current positions and the refresh of V and effm on boundary
  rows -> density sweep (kept on fluid rows) -> Tait EOS and the force
  sweep's packs (``eos_packs``) -> force sweep (``force_react`` with
  ``with_reactions``) -> symplectic Euler and the domain-box clamp
  (``advance``); on the card ``eos_packs`` and ``advance`` are one launch
  each of ``csrc/pointwise.cu`` (``ops.cuda.pointwise``).

Pair membership uses the sort-time ids and bounds of the group, and r^2
uses current positions (``wcsph.py:160-182``): a pair is missed only when
motion since the rebuild brought it within h from more than one cell away.
Every sweep takes the rows' sort-time material too, so a row that an
emitter activated inside the group (fluid now, in no cell of the rebuild)
is in no sweep's family: it keeps its density and gets no acceleration
while advect and the clamp, on the current fluid mask, move it at its
emission velocity (``tisph_tpu``'s ``keep = back_valid & fl``,
``wcsph.py:255-309``).  Without emission the two materials are equal.

With ``layout="linear"`` the density and force sweeps are the linear
layout's kernel (``WCSPH._step_fn_pallas``, ``wcsph.py:58-113``), at
R = 1: sort, bounds, density kept on fluid rows, EOS, force zeroed off
fluid rows, advect, clamp; the same pair set as the seg sweeps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tisph_tpu_torch.models.solver_base import SolverBase
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import pointwise as cuda_pointwise
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.neighbors import pack4


class GroupCache(NamedTuple):
    """What stays fixed through an R-group."""

    ids: torch.Tensor       # (N,) i32 sort-time cell ids
    bounds: torch.Tensor    # (num_cells + 1,) i32 CSR bounds of ``ids``
    material: torch.Tensor  # (N,) i32 sort-time material
    fluid: torch.Tensor     # (N,) bool
    boundary: torch.Tensor  # (N,) bool
    effm: torch.Tensor      # (N,) f32 fl * m + bd * rho0 * V (V of the rebuild)
    flm: torch.Tensor       # (N,) f32 fl * m


def group_masses(state: SimState, fluid: torch.Tensor, boundary: torch.Tensor,
                 density0: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The group's masses of the rows of ``state``: ``flm`` = fl * m and
    ``effm`` = fl * m + bd * rho0 * V, the density sweep's pack column."""
    flm = fluid.to(torch.float32) * state.mass
    return flm, flm + boundary.to(torch.float32) * (density0 * state.volume)


def per_step_volumes(delta: torch.Tensor, boundary: torch.Tensor, volume: torch.Tensor,
                     flm: torch.Tensor, density0: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``boundary_mode="per_step"``: Akinci volumes V = 1 / delta on
    boundary rows from the bvol sweep, and the refreshed ``effm`` (rho0 V
    on boundary rows is also the reaction's bvol_i)."""
    volume = torch.where(boundary, 1.0 / torch.clamp(delta, min=1e-10), volume)
    return volume, flm + torch.where(boundary, density0 * volume, 0.0)


def eos_packs(rho: torch.Tensor, state: SimState, fluid: torch.Tensor, flm: torch.Tensor,
              params) -> tuple[torch.Tensor, ...]:
    """The summed density kept on fluid rows (boundary rows keep their
    stored one), the density mode, the Tait EOS, and the force sweep's
    packs: ``(rho, pressure, vel, aux)``.  One launch of ``csrc/
    pointwise.cu`` on the card, ``ops.forces.eos_packs_plain`` on the CPU."""
    return cuda_pointwise.eos_pack(rho, state, fluid, flm, params)


def advance(state: SimState, rho: torch.Tensor, pressure: torch.Tensor, dv: torch.Tensor,
            params) -> SimState:
    """The substep's end: store rho and p, advect fluid rows by ``dv``,
    clamp to the domain box.  One launch of ``csrc/pointwise.cu`` on the
    card, ``ops.forces.advance_plain`` on the CPU."""
    return cuda_pointwise.advance(state, rho, pressure, dv, params)


class WCSPH(SolverBase):
    eager_loop = None  # a group reads nothing on the host: one CUDA graph replay
    def _build(self, state: SimState) -> tuple[SimState, GroupCache]:
        state, ids, _, bounds = cuda_bounds.sort_and_bound(state, self.spec)
        return state, self._group_cache(state, ids, bounds)

    def _group_cache(self, state: SimState, ids: torch.Tensor,
                     bounds: torch.Tensor) -> GroupCache:
        """The group's cache from the sorted state, its ids and bounds."""
        fluid, boundary = state.fluid_mask, state.boundary_mask
        flm, effm = group_masses(state, fluid, boundary, self.params.density0)
        return GroupCache(ids, bounds, state.material, fluid, boundary, effm, flm)

    def _apply(self, state: SimState, cache: GroupCache, with_reactions: bool = False):
        """One substep; with ``with_reactions`` returns ``(state,
        reactions)``, the (N, dim) fluid -> boundary forces on boundary
        rows (0 elsewhere), for the rigid-body integrator."""
        spec, params, fm = self.spec, self.params, self.fast_math
        ids, bounds, fluid, bd = cache.ids, cache.bounds, cache.fluid, cache.boundary
        material = cache.material  # rows emitted since the rebuild join no sweep

        effm = cache.effm
        if self.boundary_mode == "per_step":
            # Akinci volumes on current positions with the group's sort-time
            # structure; the bvol pack's c column is bd, not effm
            delta = cuda_sweeps.bvol_sweep(pack4(state.x, bd.to(torch.float32)), ids, bounds,
                                           material, spec, params, fm)
            volume, effm = per_step_volumes(delta, bd, state.volume, cache.flm, params.density0)
            state = dataclasses.replace(state, volume=volume)

        linear = self.layout == "linear"
        pos = pack4(state.x, effm)
        density = cuda_sweeps.density_sweep_linear if linear else cuda_sweeps.density_sweep
        rho = density(pos, ids, bounds, material, spec, params, fm)
        rho, pressure, vel, aux = eos_packs(rho, state, fluid, cache.flm, params)
        # dv on fluid rows (and the reaction on boundary rows with
        # with_reactions), 0 elsewhere, as the kernel's contract says
        if with_reactions:
            sweep = cuda_sweeps.force_react_sweep
        else:
            sweep = cuda_sweeps.force_sweep_linear if linear else cuda_sweeps.force_sweep
        dv = sweep(pos, vel, aux, ids, bounds, material, spec, params, fm)

        state = advance(state, rho, pressure, dv, params)
        if with_reactions:
            return state, torch.where(bd[:, None], dv, 0.0)
        return state
