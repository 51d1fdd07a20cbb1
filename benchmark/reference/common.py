"""What the two reference steps share: the physical constants of a scene,
the cubic spline, symplectic Euler and the pairs inside h.

The constants are those Ti-SPH hardcodes and the scene's own keys that it
reads (``compat="reference"``): dt 2e-4, Tait B = 50 and gamma = 7,
viscosity 0.05, surface tension 0.01, boundary sigma 0.08, collision
factor 0.5; h = 4 r, the clamp box [start + h, end - h] with its ends
rounded to float32 as the program stores them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.cells import CellList

FLUID, BOUNDARY, INVALID = 1, 0, -1


@dataclasses.dataclass(frozen=True)
class Physics:
    dim: int
    dt: float
    rho0: float
    stiffness: float
    exponent: float
    viscosity: float
    surface_tension: float
    boundary_sigma: float
    collision_factor: float
    c_s: float
    gravity: tuple[float, ...]
    radius: float
    domain_start: tuple[float, ...]
    domain_end: tuple[float, ...]
    # the indices in the scene's ``rigidBodies`` of its dynamic bodies, the
    # tags of their rows
    bodies: tuple[int, ...] = ()

    @property
    def h(self) -> float:
        return 4.0 * self.radius

    def box(self) -> tuple[list[float], list[float]]:
        """The clamp box [start + h, end - h], ends rounded to float32."""
        pad = np.float32(self.h)
        return ([float(np.float32(s) + pad) for s in self.domain_start],
                [float(np.float32(e) - pad) for e in self.domain_end])


def physics(scene: dict, compat: str) -> Physics:
    """The constants of a scene file (Ti-SPH's JSON schema)."""
    if compat != "reference":
        raise ValueError(f"the reference runs compat='reference' only, not {compat!r}")
    cfg = scene["configuration"]
    start = cfg["domainStart"]
    dim = int(cfg.get("dim", len(start)))
    return Physics(
        dim=dim, dt=2e-4, rho0=float(cfg.get("density0", 1000.0)), stiffness=50.0,
        exponent=7.0, viscosity=0.05, surface_tension=0.01, boundary_sigma=0.08,
        collision_factor=0.5,
        c_s=float(cfg.get("c_s", 100.0)),
        gravity=tuple(float(g) for g in cfg.get("gravitation", [0.0, -9.81, 0.0])[:dim]),
        radius=float(cfg["particleRadius"]),
        domain_start=tuple(float(s) for s in start[:dim]),
        domain_end=tuple(float(e) for e in cfg["domainEnd"][:dim]),
        bodies=tuple(k for k, b in enumerate(scene.get("rigidBodies") or [])
                     if b.get("isDynamic")))


def sigma(dim: int, h: float) -> float:
    """The cubic spline's normalisation k / h^dim."""
    return {2: 40.0 / (7.0 * math.pi), 3: 8.0 / math.pi}[dim] / h ** dim


def spline(q: torch.Tensor) -> torch.Tensor:
    """w(q): 6 (q^3 - q^2) + 1 up to 1/2, 2 (1 - q)^3 up to 1, else 0."""
    inner = 6.0 * (q ** 3 - q ** 2) + 1.0
    outer = 2.0 * (1.0 - q) ** 3
    return torch.where(q <= 0.5, inner, torch.where(q <= 1.0, outer, torch.zeros_like(q)))


def spline_dq(q: torch.Tensor) -> torch.Tensor:
    """dw/dq: 6 q (3 q - 2) up to 1/2, -6 (1 - q)^2 up to 1, else 0."""
    inner = 6.0 * q * (3.0 * q - 2.0)
    outer = -6.0 * (1.0 - q) ** 2
    return torch.where(q <= 0.5, inner, torch.where(q <= 1.0, outer, torch.zeros_like(q)))


def tait(rho: torch.Tensor, ph: Physics) -> tuple[torch.Tensor, torch.Tensor]:
    """The density clamped at rho0 and the Tait pressure B ((rho/rho0)^gamma - 1)."""
    rho = torch.clamp(rho, min=ph.rho0)
    return rho, ph.stiffness * ((rho / ph.rho0) ** ph.exponent - 1.0)


def pairs_inside(cl: CellList, x: torch.Tensor, fluid: torch.Tensor, h: float):
    """Chunks (i, j, r, r2) of the candidates of the rows that the bool
    mask ``fluid`` (aligned with the cell list's rows) selects, whose
    current distance is under h (r = x_i - x_j, self pairs included)."""
    for i, j in cl.candidates(fluid):
        r = x[i] - x[j]
        r2 = (r * r).sum(-1)
        keep = r2 < h * h
        yield i[keep], j[keep], r[keep], r2[keep]


# the dynamic bodies' state, where a state holds it: the program's
# ``RigidState`` fields, one row a body
BODY_FIELDS = ("rigid_com", "rigid_v_com", "rigid_omega")


def to_device(state: dict, device, dtype) -> dict:
    """The live rows of a host or device state (the program's field
    names), fluid and boundary, as tensors of ``dtype`` (integer fields
    int64) on ``device``, and the bodies' state (:data:`BODY_FIELDS`,
    and ``rigid_object_ids``) where it has it."""
    n = int(state["num_active"])
    out = {k: torch.as_tensor(state[k][:n]).to(device=device, dtype=dtype)
           for k in ("x", "v", "density", "pressure", "mass", "volume")}
    for k in ("material", "object_id"):
        out[k] = torch.as_tensor(state[k][:n]).to(device=device, dtype=torch.int64)
    for k in BODY_FIELDS:
        if k in state:
            out[k] = torch.as_tensor(state[k]).to(device=device, dtype=dtype)
    if "rigid_object_ids" in state:
        out["rigid_object_ids"] = torch.as_tensor(state["rigid_object_ids"]).to(
            device=device, dtype=torch.int64)
    return out
