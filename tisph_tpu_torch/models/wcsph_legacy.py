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

Each step rebuilds (``sort_and_bound``) and runs the two pair sums, the
kernel ``csrc/legacy.cu`` on the card (``ops.cuda.legacy``) and its plain
versions on the CPU (``ops.neighbors.legacy_*``): ``tisph_tpu`` runs them
as jnp sweeps and no TPU kernel.  The self pair is excluded and a pair
counts when r^2 < h^2 (``tisph_tpu/ops/neighbors.py:160-163``).  The row
ops around the sums (the pos pack; the density keep, the EOS and the
force packs; advection and the clamp) are three launches of
``csrc/legacy_rows.cu`` on the card (``ops.cuda.legacy_rows``) and their
plain versions on the CPU.  Both sums run over every row and are masked:
a step reads nothing on the host, so on the card it replays as one CUDA
graph (the rebuild and one step, ``models.graphs``), as ``tisph_tpu``
runs a legacy step as one jit.
"""

from __future__ import annotations

import dataclasses

import torch

from tisph_tpu_torch.models.solver_base import SolverBase
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import legacy as cuda_legacy
from tisph_tpu_torch.ops.cuda import legacy_rows as cuda_legacy_rows
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.neighbors import pack4


class WCSPHLegacy(SolverBase):
    layouts = ("seg",)
    eager_loop = None  # a step reads nothing on the host: one CUDA graph replay

    def _check_resort(self, R: int) -> None:
        super()._check_resort(R)
        if R > 1:
            raise ValueError(f"resort_every={R}: the legacy solver rebuilds every step (R = 1)")

    def _build(self, state: SimState):
        state, ids, _, bounds = cuda_bounds.sort_and_bound(state, self.spec)
        return state, (ids, bounds)

    def _apply(self, state: SimState, cache) -> SimState:
        ids, bounds = cache
        params, spec = self.params, self.spec

        if self.boundary_mode == "per_step":
            bd = state.boundary_mask
            delta = cuda_sweeps.bvol_sweep(pack4(state.x, bd.to(torch.float32)), ids, bounds,
                                           state.material, spec, params, self.fast_math)
            volume = torch.where(bd, 1.0 / torch.clamp(delta, min=1e-10), state.volume)
            state = dataclasses.replace(state, volume=volume)

        pos = cuda_legacy_rows.legacy_pos_pack(state)
        acc = cuda_legacy.legacy_density_sweep(pos, ids, bounds, state.material, spec, params)
        rho, pressure, vel, aux = cuda_legacy_rows.legacy_eos_pack(acc, state, params)
        dv = cuda_legacy.legacy_force_sweep(pos, vel, aux, ids, bounds, state.material, spec,
                                            params)
        return cuda_legacy_rows.legacy_advance(state, rho, pressure, dv, params)
