"""The V2 step (Ti-SPH's SPHBaseV2 + WCSPHV2, ``main_3d.py``'s solver) in
plain PyTorch, for fluid rows and static boundary rows (Akinci et al.
2012, "Versatile rigid-fluid coupling for incompressible SPH", ACM TOG
31(4)), at a rebuild cadence R.

A group bins the positions once; each of its R substeps takes as
candidates of a row the rows of the 3^dim cells around its cell at that
binning, and keeps those within h at the current positions.  Sums over j
run over fluid neighbours f and boundary neighbours b.  A group first
takes each boundary row's volume, from the boundary rows alone (the self
pair included):

- V_b = 1 / sum_b' W_bb',  psi_b = rho0 V_b (Akinci's eq. 4 and 5).

A substep, on fluid rows i:

- density  rho_i = sum_f m_f W_if + sum_b psi_b W_ib, the self pair
  included (Akinci's eq. 6);
- Tait EOS with the clamp at rho0;
- dv_i = g - sum_f m_f (p_i / rho_i^2 + p_f / rho_f^2) grad W_if
  + sum_f m_f nu_if min(v_if . r_if, 0) / (r^2 + 0.01 h^2) grad W_if
  - (sigma_st / m_i) sum_f m_f W_if r_if,  nu_if = 2 nu h c_s / (rho_i + rho_f);
  - sum_b psi_b (p_i / rho_i^2) grad W_ib (Akinci's eq. 10)
  + sum_b psi_b nu_b,i min(v_ib . r_ib, 0) / (r^2 + 0.01 h^2) grad W_ib,
  nu_b,i = sigma_b h c_s / (2 rho_i), sigma_b = 0.08 (Akinci's eq. 11-12);
- symplectic Euler, then the clamp into the box with the reflection
  v -= (1 + c_f) (v . n) n about the summed normal of the violated faces.

Boundary rows are static: neither advected nor clamped, their position
and velocity (zero) as given.  Their density is their stored one clamped
at rho0 (the block's density, rho0 in the benchmark's scenes), their
pressure its Tait pressure (0 there); no fluid row reads either.

Departures from Akinci's paper, as Ti-SPH's V2 has them: psi_b takes the
scene's rho0, not each fluid's own rest density; V_b sums over every
boundary row within h, of any block; the boundary exerts no cohesion or
adhesion on the fluid; the fluid exerts no force on the boundary, which
does not move (the reaction that two-way coupling adds is not here).
With no boundary row a group takes the same operations as a pure fluid
step.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.cells import CellList
from benchmark.reference.common import (BOUNDARY, FLUID, Physics, pairs_inside, sigma, spline,
                                        spline_dq, tait)


def boundary_volumes(x: torch.Tensor, boundary: torch.Tensor, ph: Physics,
                     cl: CellList | None = None) -> torch.Tensor:
    """Akinci's V_b = 1 / sum_b' W_bb' over the boundary rows within h,
    the self pair included, on the rows the bool mask ``boundary``
    selects; 0 on the others.  The candidates come from ``cl``, a cell
    list of every row binned earlier in the group, or else from a cell
    list of the boundary rows binned at ``x``."""
    k = sigma(ph.dim, ph.h)
    own = cl is None
    if own:
        rows = torch.nonzero(boundary).squeeze(1)
        cl = CellList(x, rows, ph.domain_start, ph.domain_end, ph.h)
    which = torch.ones_like(cl.rows, dtype=torch.bool) if own else boundary[cl.rows]
    delta = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, j, _, r2 in pairs_inside(cl, x, which, ph.h):
        if not own:  # the candidates of every row: keep the boundary j
            i, r2 = i[boundary[j]], r2[boundary[j]]
        delta.index_add_(0, i, k * spline(torch.sqrt(r2) / ph.h))
    return torch.where(boundary, 1.0 / torch.where(boundary, delta, 1.0), 0.0)


class Box:
    """The clamp box of a state's dtype and device, and the band of two
    float32 steps about each face inside which a stored position may take
    either branch of the clamp."""

    def __init__(self, ph: Physics, like: torch.Tensor):
        self.lo, self.hi = (torch.tensor(b, dtype=like.dtype, device=like.device)
                            for b in ph.box())
        self.lo_eps, self.hi_eps = (
            2.0 * torch.tensor([float(np.spacing(np.float32(abs(a)))) for a in b],
                               dtype=like.dtype, device=like.device) for b in ph.box())


def stored(dtype: torch.dtype):
    """``rnd(t)``: ``t`` rounded to the state's stored precision, float32
    for a float64 reference and the dtype itself below it."""
    store = torch.float32 if dtype == torch.float64 else dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(store).to(t.dtype)
    return rnd


def density(pairs: list, effm: torch.Tensor, fluid: torch.Tensor, rho_stored: torch.Tensor,
            ph: Physics) -> tuple[torch.Tensor, torch.Tensor]:
    """Akinci's eq. 6 on fluid rows (boundary rows keep ``rho_stored``),
    then the Tait EOS: (rho, p)."""
    k, h = sigma(ph.dim, ph.h), ph.h
    rho = torch.zeros_like(rho_stored)
    for i, j, _, r2 in pairs:
        rho.index_add_(0, i, effm[j] * k * spline(torch.sqrt(r2) / h))
    return tait(torch.where(fluid, rho, rho_stored), ph)


def accelerations(pairs: list, x: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                  psi: torch.Tensor, boundary: torch.Tensor, walls: bool, rho: torch.Tensor,
                  p: torch.Tensor, ph: Physics, reaction: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """dv of each fluid row i over its ``pairs`` (the module's docstring),
    gravity included; with ``reaction``, adds into it on each boundary row
    b the force its terms exert on the fluid with the sign turned,
    -sum_f m_f dv_f<-b."""
    k, h = sigma(ph.dim, ph.h), ph.h
    g = torch.tensor(ph.gravity, dtype=x.dtype, device=x.device)
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
        acc = (visc - press)[:, None] * grad - coh
        if walls:  # from a boundary neighbour: Akinci's pressure and viscosity
            nu_b = ph.boundary_sigma * h * ph.c_s / (2.0 * rho[i])
            wall = psi[j] * (nu_b * torch.clamp(vr, max=0.0) / (r2 + 0.01 * h * h)
                             - p_rho2[i])
            acc = torch.where(boundary[j][:, None], wall[:, None] * grad, acc)
            if reaction is not None:
                b = boundary[j]
                reaction.index_add_(0, j[b], -m[i[b]][:, None] * acc[b])
        dv.index_add_(0, i, acc)
    return dv


def advance(x: torch.Tensor, v: torch.Tensor, dv: torch.Tensor, fluid: torch.Tensor,
            box: Box, ph: Physics, rnd) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symplectic Euler of the fluid rows, then the clamp into the box
    with its reflection, each stored by ``rnd``; (x, v, tie), ``tie`` the
    components of fluid rows whose stored position fell within the band
    of a face: an input a float32 step off takes the clamp's other branch
    there, and the reflection about the summed normal then also moves the
    row's other clamped axes."""
    dt = ph.dt
    move = fluid[:, None]  # other rows are neither advected nor clamped
    dv = torch.where(move, dv, 0.0)
    v = rnd(torch.where(move, v + dt * dv, v))
    x = rnd(torch.where(move, x + dt * v, x))
    near = move & (((x - box.lo).abs() <= box.lo_eps) | ((x - box.hi).abs() <= box.hi_eps))
    normal = torch.where(move, (x > box.hi).to(x.dtype) - (x <= box.lo).to(x.dtype), 0.0)
    tie = near | ((normal != 0) & near.any(-1, keepdim=True))
    x = torch.where(move, torch.minimum(torch.maximum(x, box.lo), box.hi), x)
    n_len = torch.sqrt((normal * normal).sum(-1, keepdim=True))
    n_hat = normal / torch.clamp(n_len, min=1e-6)
    v = rnd(torch.where(n_len > 1e-6, v - (1.0 + ph.collision_factor)
                        * (v * n_hat).sum(-1, keepdim=True) * n_hat, v))
    return x, v, tie


def group(st: dict, R: int, ph: Physics) -> dict:
    """R substeps of ``st`` (live fluid and boundary rows, tensors of one
    float dtype) from one binning, the state stored in float32 after each
    (bfloat16 when the dtype is); returns x, v, density, pressure,
    ``volume_b`` (V_b on boundary rows, 0 on fluid rows) and ``tie``, per
    row and axis, the components of fluid rows that a clamp decision within
    rounding of a face may have changed, rows as given."""
    x, v, m = st["x"], st["v"], st["mass"]
    rows = torch.arange(x.shape[0], device=x.device)
    fluid = st["material"] == FLUID
    boundary = st["material"] == BOUNDARY
    walls = bool(boundary.any())
    vb = boundary_volumes(x, boundary, ph) if walls else torch.zeros_like(m)
    psi = ph.rho0 * vb
    effm = torch.where(boundary, psi, m) if walls else m  # m_f, or psi_b
    cl = CellList(x, rows, ph.domain_start, ph.domain_end, ph.h)
    box, rnd = Box(ph, x), stored(x.dtype)
    rho_stored = st["density"]
    tie = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(R):
        pairs = list(pairs_inside(cl, x, fluid, ph.h))
        rho, p = density(pairs, effm, fluid, rho_stored, ph)
        dv = accelerations(pairs, x, v, m, psi, boundary, walls, rho, p, ph)
        x, v, moved = advance(x, v, dv, fluid, box, ph, rnd)
        tie |= moved
        rho_stored, out_p = rnd(rho), rnd(p)
    return {"x": x, "v": v, "density": rho_stored, "pressure": out_p, "volume_b": vb,
            "tie": tie}
