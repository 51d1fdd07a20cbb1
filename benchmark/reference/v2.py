"""The V2 step (Ti-SPH's SPHBaseV2 + WCSPHV2, ``main_3d.py``'s solver) in
plain PyTorch, for fluid rows, at a rebuild cadence R.

A group bins the positions once; each of its R substeps takes as
candidates of a row the rows of the 3^dim cells around its cell at that
binning, and keeps those within h at the current positions.  A substep:

- density  rho_i = sum_j m_j W_ij, the self pair included;
- Tait EOS with the clamp at rho0;
- dv_i = g - sum_j m_j (p_i / rho_i^2 + p_j / rho_j^2) grad W_ij
  + sum_j m_j nu_ij min(v_ij . r_ij, 0) / (r^2 + 0.01 h^2) grad W_ij
  - (sigma_st / m_i) sum_j m_j W_ij r_ij,  nu_ij = 2 nu h c_s / (rho_i + rho_j);
- symplectic Euler, then the clamp into the box with the reflection
  v -= (1 + c_f) (v . n) n about the summed normal of the violated faces.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.cells import CellList
from benchmark.reference.common import FLUID, Physics, pairs_inside, sigma, spline, spline_dq, tait


def group(st: dict, R: int, ph: Physics) -> dict:
    """R substeps of ``st`` (live fluid rows, tensors of one float dtype)
    from one binning, the state stored in float32 after each (bfloat16 when
    the dtype is); returns x, v, density, pressure and ``tie``, per row
    and axis, the components that a clamp decision within rounding of a
    face may have changed, rows as given."""
    x, v, m = st["x"], st["v"], st["mass"]
    dt, h = ph.dt, ph.h
    k = sigma(ph.dim, h)
    rows = torch.arange(x.shape[0], device=x.device)
    fluid = st["material"] == FLUID
    cl = CellList(x, rows, ph.domain_start, ph.domain_end, h)
    g = torch.tensor(ph.gravity, dtype=x.dtype, device=x.device)
    lo, hi = (torch.tensor(b, dtype=x.dtype, device=x.device) for b in ph.box())
    rho_stored = st["density"]
    store = torch.float32 if x.dtype == torch.float64 else x.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:  # the state's stored precision
        return t.to(store).to(t.dtype)

    # axes on which a row's stored position fell within two float32 steps of
    # a face of the clamp box: an input a step off, as float32 arithmetic
    # gives, takes the clamp's other branch there; the reflection about the
    # summed normal then also moves the row's other clamped axes
    lo_eps, hi_eps = (2.0 * torch.tensor([float(np.spacing(np.float32(abs(a)))) for a in b],
                                         dtype=x.dtype, device=x.device) for b in ph.box())
    tie = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(R):
        rho = torch.zeros_like(rho_stored)
        pairs = list(pairs_inside(cl, x, fluid, h))
        for i, j, _, r2 in pairs:
            rho.index_add_(0, i, m[j] * k * spline(torch.sqrt(r2) / h))
        rho, p = tait(torch.where(fluid, rho, rho_stored), ph)
        p_rho2 = p / (rho * rho)
        dv = g.expand_as(x).clone()
        for i, j, r, r2 in pairs:
            dist = torch.sqrt(r2)
            q = dist / h
            safe = torch.where(dist > 0, dist, torch.ones_like(dist))
            grad = (k / h) * torch.where(dist > 0, spline_dq(q) / safe, 0.0)[:, None] * r
            vr = ((v[i] - v[j]) * r).sum(-1)
            nu = 2.0 * ph.viscosity * h * ph.c_s / (rho[i] + rho[j])
            visc = m[j] * nu * torch.clamp(vr, max=0.0) / (r2 + 0.01 * h * h)
            press = m[j] * (p_rho2[i] + p_rho2[j])
            coh = (ph.surface_tension * m[j] / m[i] * k * spline(q))[:, None] * r
            dv.index_add_(0, i, (visc - press)[:, None] * grad - coh)
        dv = torch.where(fluid[:, None], dv, 0.0)
        v = rnd(v + dt * dv)
        x = rnd(x + dt * v)
        near = ((x - lo).abs() <= lo_eps) | ((x - hi).abs() <= hi_eps)
        normal = (x > hi).to(x.dtype) - (x <= lo).to(x.dtype)
        tie |= near | ((normal != 0) & near.any(-1, keepdim=True))
        x = torch.minimum(torch.maximum(x, lo), hi)
        n_len = torch.sqrt((normal * normal).sum(-1, keepdim=True))
        n_hat = normal / torch.clamp(n_len, min=1e-6)
        v = rnd(torch.where(n_len > 1e-6, v - (1.0 + ph.collision_factor)
                            * (v * n_hat).sum(-1, keepdim=True) * n_hat, v))
        rho_stored, out_p = rnd(rho), rnd(p)
    return {"x": x, "v": v, "density": rho_stored, "pressure": out_p, "tie": tie}
