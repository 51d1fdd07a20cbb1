"""The V2 step with dynamic rigid bodies and two-way coupling in plain
PyTorch: Akinci et al. 2012's boundary terms (``v2.py``) on every
boundary row, and each dynamic body moved as one rigid composite by the
force and torque the fluid exerts on its rows.

A group bins the positions once (``v2.py``); each of its R substeps, on
the live rows as given:

1. V_b = 1 / sum_b' W_bb' on every boundary row, on the current
   positions (the bodies move), with the group's candidates;
2. the density of the fluid rows and the Tait EOS (``v2.density``);
3. the fluid rows' dv with Akinci's terms (``v2.accelerations``), and on
   each boundary row b the reaction F_b = -sum_f m_f dv_f<-b, what its
   terms exert on the fluid with the sign turned;
4. symplectic Euler and the clamp on the fluid rows (``v2.advance``);
5. each dynamic body k (its rows: boundary rows tagged k, the body's
   index in the scene's ``rigidBodies``), from its state at the substep's
   start (COM c, v_com, omega, M the sum of its rows' masses):
   F = sum_b F_b, tau = sum_b (x_b - c) x F_b, I = sum_b m_b (|r|^2 1 -
   r r^T) of the current rows about c; v_com += dt (F / M + g);
   omega += dt I^-1 tau (in 2D omega_z += dt tau_z / I_zz); the wall
   contact: p_lo and p_hi, the deepest reach of the body's rows below and
   above the clamp box on each axis, v_com on an axis that reaches out
   turned by -c_f (c_f = 0.5), and c' = c + dt v_com + p_lo - p_hi;
   each row moved rigidly: v_b = v_com + omega x r, x_b = c' + Rot(omega
   dt) r, r = x_b - c its offset at the substep's start and Rot the exact
   rotation by the vector omega dt (Rodrigues).

The state is stored in float32 after each substep, the bodies' state
too (bfloat16 when the dtype is).  A state that holds no body state
(S0) starts each body at rest, with its COM the mass-weighted mean of its
rows, as the program's ``init_rigid`` does.

Departures from ``tisph_tpu_torch/models/rigid.py`` (each far below
float32 rounding of the quantities compared, or of the same value):

- M is summed in float64 from the rows of the state given, where the
  program sums its float32 masses once at the start;
- the inertia has no 1e-8 added on its diagonal (the program's guard
  against a singular matrix), and I^-1 tau is taken by the adjugate;
- the reaction is gathered from the fluid rows' pairs, each pair's term
  with its sign turned, where the program sweeps the boundary rows and
  sums their pairs (the same pairs: the cell stencil and r < h are
  symmetric);
- the wall contact takes no float32 band about the box's faces: a body
  row within rounding of a face may take the other branch (no cell holds
  a body that reaches the box in its checked steps yet).
"""

from __future__ import annotations

import torch

from benchmark.reference.cells import CellList
from benchmark.reference.common import BOUNDARY, FLUID, Physics, pairs_inside
from benchmark.reference.v2 import Box, accelerations, advance, boundary_volumes, density, stored


def _pad3(a: torch.Tensor) -> torch.Tensor:
    """(..., dim) -> (..., 3), 2D in the xy plane."""
    return a if a.shape[-1] == 3 else torch.nn.functional.pad(a, (0, 3 - a.shape[-1]))


def rotation(phi: torch.Tensor) -> torch.Tensor:
    """The 3x3 matrix of the rotation by the vector ``phi``: I + (sin t /
    t) K + ((1 - cos t) / t^2) K^2, K = [phi]x, t = |phi|, with the
    coefficients' series below t = 1e-4."""
    t2 = (phi * phi).sum()
    t = torch.sqrt(t2)
    small = t < 1e-4
    safe = torch.where(small, torch.ones_like(t), t)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    z = torch.zeros_like(t)
    k = torch.stack([torch.stack([z, -phi[2], phi[1]]), torch.stack([phi[2], z, -phi[0]]),
                     torch.stack([-phi[1], phi[0], z])])
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + a * k + b * (k @ k)


def solve3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b for a 3x3 ``a``, by the adjugate (any float dtype)."""
    c0, c1, c2 = (torch.linalg.cross(a[1], a[2]), torch.linalg.cross(a[2], a[0]),
                  torch.linalg.cross(a[0], a[1]))
    adj = torch.stack([c0, c1, c2], dim=1)  # adj(a) = [c0 c1 c2] as columns
    return (adj @ b) / (a[0] * c0).sum()


def start_bodies(st: dict, rows: list[torch.Tensor]) -> dict:
    """The bodies' state of ``st``, or at rest with the COM of their rows;
    their masses from the rows."""
    x, m = st["x"], st["mass"]
    mass = torch.stack([m[r].sum() for r in rows])
    if "rigid_com" in st:
        return {"com": st["rigid_com"], "v_com": st["rigid_v_com"],
                "omega": st["rigid_omega"], "mass": mass}
    com = torch.stack([(x[r] * m[r][:, None]).sum(0) for r in rows]) / mass[:, None]
    return {"com": com, "v_com": torch.zeros_like(com),
            "omega": torch.zeros((len(rows), 3), dtype=x.dtype, device=x.device), "mass": mass}


def move_bodies(x: torch.Tensor, v: torch.Tensor, m: torch.Tensor, rows: list[torch.Tensor],
                reaction: torch.Tensor, body: dict, box: Box, ph: Physics, rnd
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Step 5 of the module's docstring: every dynamic body and its rows."""
    dim, dt = x.shape[1], ph.dt
    g = torch.tensor(ph.gravity, dtype=x.dtype, device=x.device)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    com, v_com, omega = [], [], []
    x, v = x.clone(), v.clone()
    for k, r_k in enumerate(rows):
        c, xb, mb, fb = body["com"][k], x[r_k], m[r_k], reaction[r_k]
        r = _pad3(xb - c)
        tau = torch.linalg.cross(r, _pad3(fb)).sum(0)
        inertia = (mb[:, None, None] * ((r * r).sum(-1)[:, None, None] * eye
                                        - r[:, :, None] * r[:, None, :])).sum(0)
        vc = body["v_com"][k] + dt * (fb.sum(0) / body["mass"][k] + g)
        if dim == 2:
            w = body["omega"][k] + dt * torch.stack([torch.zeros_like(tau[2])] * 2
                                                    + [tau[2] / inertia[2, 2]])
        else:
            w = body["omega"][k] + dt * solve3(inertia, tau)
        p_lo = torch.clamp(box.lo - xb, min=0.0).amax(0)
        p_hi = torch.clamp(xb - box.hi, min=0.0).amax(0)
        vc = torch.where((p_lo > 0) | (p_hi > 0), -ph.collision_factor * vc, vc)
        c_new = c + dt * vc + (p_lo - p_hi)
        x[r_k] = rnd(c_new + (r @ rotation(w * dt).T)[:, :dim])
        v[r_k] = rnd(vc + torch.linalg.cross(w.expand_as(r), r)[:, :dim])
        com.append(rnd(c_new))
        v_com.append(rnd(vc))
        omega.append(rnd(w))
    return x, v, body | {"com": torch.stack(com), "v_com": torch.stack(v_com),
                         "omega": torch.stack(omega)}


def group(st: dict, R: int, ph: Physics) -> dict:
    """R coupled substeps of ``st`` (live rows, tensors of one float
    dtype, and the bodies' state where it has it) from one binning;
    returns what ``v2.group`` does, ``volume_b`` from the last substep,
    and the bodies' ``rigid_object_ids``, ``rigid_com``, ``rigid_v_com``
    and ``rigid_omega``, one row a body in the order of ``ph.bodies``."""
    x, v, m = st["x"], st["v"], st["mass"]
    fluid = st["material"] == FLUID
    boundary = st["material"] == BOUNDARY
    rows = [torch.nonzero(boundary & (st["object_id"] == k)).squeeze(1) for k in ph.bodies]
    body = start_bodies(st, rows)
    cl = CellList(x, torch.arange(x.shape[0], device=x.device), ph.domain_start,
                  ph.domain_end, ph.h)
    box, rnd = Box(ph, x), stored(x.dtype)
    rho_stored = st["density"]
    tie = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(R):
        vb = boundary_volumes(x, boundary, ph, cl)
        psi = ph.rho0 * vb
        effm = torch.where(boundary, psi, m)
        pairs = list(pairs_inside(cl, x, fluid, ph.h))
        rho, p = density(pairs, effm, fluid, rho_stored, ph)
        reaction = torch.zeros_like(x)
        dv = accelerations(pairs, x, v, m, psi, boundary, True, rho, p, ph, reaction)
        x, v, moved = advance(x, v, dv, fluid, box, ph, rnd)
        tie |= moved
        x, v, body = move_bodies(x, v, m, rows, reaction, body, box, ph, rnd)
        rho_stored, out_p = rnd(rho), rnd(p)
    return {"x": x, "v": v, "density": rho_stored, "pressure": out_p, "volume_b": vb,
            "tie": tie, "rigid_object_ids": torch.tensor(ph.bodies, device=x.device),
            "rigid_com": body["com"], "rigid_v_com": body["v_com"],
            "rigid_omega": body["omega"]}
