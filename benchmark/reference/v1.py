"""The V1 step (Ti-SPH's SPHBase + WCSPH, ``main.py``'s solver) in plain
PyTorch, for fluid rows; it bins every step (R = 1).

A step, over the pairs j != i with r^2 < h^2 and the particle mass
m_V = 0.8 d^dim (d the particle diameter):

- density  rho_i = rho0 sum_j m_V W_ij, no self term;
- Tait EOS with the clamp at rho0;
- dv_i = (0, ..., -9.80)
  + sum_j 2 (dim + 2) nu (m_V rho0 / rho_j) (v_ij . r_ij) / (r^2 + 0.01 h^2) grad W_ij
  - sum_j rho0 m_V (p_i / rho_i^2 + p_j / rho_j^2) grad W_ij,
  grad W 0 where |r| <= 1e-5;
- symplectic Euler, then per axis the clamp into the box and, on each
  axis outside it, v_a -= (1 + c_f) v_a.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.cells import CellList
from benchmark.reference.common import FLUID, Physics, pairs_inside, sigma, spline, spline_dq, tait


def group(st: dict, R: int, ph: Physics) -> dict:
    """R steps of ``st`` (live fluid rows, tensors of one float dtype),
    each from its own binning, the state stored in float32 after each
    (bfloat16 when the dtype is); returns x, v, density, pressure and
    ``tie``, per row and axis, the components whose clamp decision fell
    within rounding of a face."""
    x, v = st["x"], st["v"]
    dt, h, dim = ph.dt, ph.h, ph.dim
    k = sigma(dim, h)
    m_v = 0.8 * (2.0 * ph.radius) ** dim
    rows = torch.arange(x.shape[0], device=x.device)
    fluid = st["material"] == FLUID
    if not bool(fluid.all()):
        raise NotImplementedError("the V1 reference holds fluid rows only: it has no boundary "
                                  "terms of the legacy solver")
    g = torch.zeros(dim, dtype=x.dtype, device=x.device)
    g[-1] = -9.80
    lo, hi = (torch.tensor(b, dtype=x.dtype, device=x.device) for b in ph.box())
    rho_stored = st["density"]
    store = torch.float32 if x.dtype == torch.float64 else x.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:  # the state's stored precision
        return t.to(store).to(t.dtype)

    # axes on which a row's stored position fell within two float32 steps of
    # a face of the clamp box: an input a step off, as float32 arithmetic
    # gives, takes the clamp's other branch there (per axis in V1)
    lo_eps, hi_eps = (2.0 * torch.tensor([float(np.spacing(np.float32(abs(a)))) for a in b],
                                         dtype=x.dtype, device=x.device) for b in ph.box())
    tie = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(R):
        cl = CellList(x, rows, ph.domain_start, ph.domain_end, h)
        pairs = [(i[i != j], j[i != j], r[i != j], r2[i != j])
                 for i, j, r, r2 in pairs_inside(cl, x, fluid, h)]
        rho = torch.zeros_like(rho_stored)
        for i, j, _, r2 in pairs:
            rho.index_add_(0, i, torch.where(fluid[j], m_v * k * spline(torch.sqrt(r2) / h), 0.0))
        rho, p = tait(torch.where(fluid, ph.rho0 * rho, rho_stored), ph)
        p_rho2 = p / (rho * rho)
        dv = g.expand_as(x).clone()
        for i, j, r, r2 in pairs:
            dist = torch.sqrt(r2)
            safe = torch.clamp(dist, min=1e-5)
            grad = (k / h) * torch.where(dist > 1e-5, spline_dq(dist / h) / safe, 0.0)[:, None] * r
            vr = ((v[i] - v[j]) * r).sum(-1)
            visc = 2.0 * (dim + 2) * ph.viscosity * (m_v * ph.rho0 / rho[j]) * vr / (
                r2 + 0.01 * h * h)
            press = torch.where(fluid[j], ph.rho0 * m_v * (p_rho2[i] + p_rho2[j]), 0.0)
            dv.index_add_(0, i, (visc - press)[:, None] * grad)
        dv = torch.where(fluid[:, None], dv, 0.0)
        v = rnd(v + dt * dv)
        x = rnd(x + dt * v)
        tie |= ((x - lo).abs() <= lo_eps) | ((x - hi).abs() <= hi_eps)
        out = (x < lo) | (x > hi)
        x = torch.minimum(torch.maximum(x, lo), hi)
        v = rnd(torch.where(out, v - (1.0 + ph.collision_factor) * v, v))
        rho_stored, out_p = rnd(rho), rnd(p)
    return {"x": x, "v": v, "density": rho_stored, "pressure": out_p, "tie": tie}
