"""WCSPHLegacy: the reference's V1 physics (SPHBase + WCSPH), as
``tisph_tpu.models.wcsph_legacy`` runs it.

What differs from the V2 flagship (:mod:`models.wcsph`):

- density rho_i = rho0 sum over fluid j of m_V W_ij, with the scalar
  m_V = 0.8 d^dim and no self term;
- gravity the scalar -9.80 on the last axis, and a Laplacian-style
  viscosity 2 (dim + 2) nu (m_V rho0 / rho_j) (v_ij . r) / (|r|^2 +
  0.01 h^2) grad W over every neighbour;
- pressure -rho0 m_V (p_i / rho_i^2 + p_j / rho_j^2) grad W for fluid j
  and the Akinci term -rho0 V_j (p_i / rho_i^2) grad W for boundary j;
- the per-axis domain clamp (displace, then reflect the violating
  components), which ``reference_exact`` leaves out as the reference's V1
  does (its ``enforce_boundary`` is never called).

Each step rebuilds (``sort_and_bound``) and runs two pair sums written in
PyTorch on ``ops.neighbors.candidates``, on either device: ``tisph_tpu``
runs them as jnp sweeps and no TPU kernel.  The self pair is excluded and a
pair counts when r^2 < h^2 (``tisph_tpu/ops/neighbors.py:160-163``).
"""

from __future__ import annotations

import dataclasses

import torch

from tisph_tpu_torch.models.solver_base import SolverBase
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops import forces as F
from tisph_tpu_torch.ops.consts import device_constant
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.eos import tait_pressure
from tisph_tpu_torch.ops.kernels import cubic_kernel, cubic_kernel_grad
from tisph_tpu_torch.ops.neighbors import candidates, pack4


class WCSPHLegacy(SolverBase):
    layouts = ("seg",)
    eager_loop = ("its pair sums run torch.nonzero, a host read (_pairs); fixed-shape pair "
                  "lists in its place are later work")

    def _check_resort(self, R: int) -> None:
        super()._check_resort(R)
        if R > 1:
            raise ValueError(f"resort_every={R}: the legacy solver rebuilds every step (R = 1)")

    def _build(self, state: SimState):
        state, ids, _, bounds = cuda_bounds.sort_and_bound(state, self.spec)
        return state, (ids, bounds)

    def _pairs(self, x: torch.Tensor, ids, bounds, rows_i):
        """The pairs (i, j) of the rows ``rows_i`` with j != i and r^2 <
        h^2, as chunks ``(i, j, r, r2)`` with r = x_i - x_j."""
        h2 = self.params.support_length ** 2
        for i, j in candidates(ids, bounds, rows_i, self.spec):
            r = x[i] - x[j]
            r2 = torch.sum(r * r, dim=-1)
            keep = torch.nonzero((r2 < h2) & (i != j)).squeeze(1)
            yield i[keep], j[keep], r[keep], r2[keep]

    def _apply(self, state: SimState, cache) -> SimState:
        ids, bounds = cache
        params, spec = self.params, self.spec
        dim, h = params.dim, params.support_length
        m_v = 0.8 * (2.0 * params.particle_radius) ** dim
        mass = m_v * params.density0

        if self.boundary_mode == "per_step":
            bd = state.boundary_mask
            delta = cuda_sweeps.bvol_sweep(pack4(state.x, bd.to(torch.float32)), ids, bounds,
                                           state.material, spec, params, self.fast_math)
            volume = torch.where(bd, 1.0 / torch.clamp(delta, min=1e-10), state.volume)
            state = dataclasses.replace(state, volume=volume)

        fluid = state.fluid_mask
        fl = fluid.to(torch.float32)
        bound = (~fluid & state.active_mask).to(torch.float32)
        rows = torch.nonzero(fluid).squeeze(1)
        pairs = list(self._pairs(state.x, ids, bounds, rows))

        acc = torch.zeros_like(state.density)
        for i, j, _, r2 in pairs:
            acc.index_add_(0, i, fl[j] * m_v * cubic_kernel(torch.sqrt(r2), h, dim))
        density = torch.where(fluid, params.density0 * acc, state.density)
        rho, pressure = tait_pressure(density, params.density0, params.stiffness,
                                      params.exponent)

        p_rho2 = pressure / (rho * rho)
        visc = 2.0 * (dim + 2) * params.viscosity
        gravity = device_constant([0.0] * (dim - 1) + [-9.80], torch.float32, state.device)
        dv = gravity.expand_as(state.x).clone()
        for i, j, r, r2 in pairs:
            rho_j = rho[j]
            dot = torch.sum((state.v[i] - state.v[j]) * r, dim=-1)
            coef = visc * (mass / rho_j) * dot / (r2 + 0.01 * h * h)
            coef = coef - fl[j] * (params.density0 * m_v) * (p_rho2[i] + pressure[j] / (rho_j * rho_j))
            coef = coef - bound[j] * (params.density0 * state.volume[j]) * p_rho2[i]
            dv.index_add_(0, i, coef[:, None] * cubic_kernel_grad(r, h, dim))
        dv = torch.where(fluid[:, None], dv, 0.0)

        state = F.advect(dataclasses.replace(state, density=rho, pressure=pressure), dv, params)
        if params.reference_exact:
            return state  # the reference's V1 never calls its domain clamp
        return self._enforce_boundary_v1(state)

    def _enforce_boundary_v1(self, state: SimState) -> SimState:
        """Per axis: clamp into [start + padding, end - padding] and reflect
        a violating velocity component, v -= (1 + c_f) v."""
        params = self.params
        lo, hi = F.domain_box(params, state.device)
        fluid = state.fluid_mask[:, None]
        out = (state.x < lo) | (state.x > hi)
        x = torch.where(fluid, torch.clamp(state.x, min=lo, max=hi), state.x)
        v = torch.where(fluid & out, state.v - (1.0 + params.collision_factor) * state.v, state.v)
        return dataclasses.replace(state, x=x, v=v)
