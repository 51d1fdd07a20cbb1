"""Dynamic rigid bodies with two-way fluid coupling (Akinci-style).

The scheme of ``tisph_tpu.models.rigid``:

- a dynamic body's particles keep ``material = MATERIAL_BOUNDARY``: the
  fluid sees the usual boundary pressure and viscosity terms, with the
  boundary volumes recomputed every substep because the body moves;
- the reaction forces of those terms (the sweep kernel's ``force_react``
  mode on boundary rows) are reduced per body into a net force and torque;
- each body integrates as a rigid composite: v_com += dt (F/M + g),
  omega += dt I^-1 tau with the inertia of the current particles about the
  COM; its particles get v_p = v_com + omega x r, and their offsets are
  rotated by the EXACT rotation Rot(omega dt) about the new COM, so the
  shape holds to rounding over long runs;
- wall contact: a body whose particles reach into the domain padding is
  pushed back on its COM, and the COM velocity is reflected and damped by
  the collision factor on the axes that hit.

All per-body work is a Python loop over the K bodies (K is fixed) of
masked reductions over the particles: nothing is read back to the host
during a rollout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tisph_tpu_torch.config import SceneConfig, SolverParams
from tisph_tpu_torch.models.state import MATERIAL_BOUNDARY, SimState
from tisph_tpu_torch.ops.consts import device_constant
from tisph_tpu_torch.ops.forces import domain_box

_RIGID_FIELDS = {"object_ids": np.int32, "mass": np.float32, "com": np.float32,
                 "v_com": np.float32, "omega": np.float32}


@dataclasses.dataclass(frozen=True)
class RigidState:
    """State of the K dynamic bodies, on the simulation's device."""

    object_ids: torch.Tensor  # (K,) i32, the object_id of each body
    mass: torch.Tensor        # (K,) f32
    com: torch.Tensor         # (K, dim) f32
    v_com: torch.Tensor       # (K, dim) f32
    omega: torch.Tensor       # (K, 3) f32; 2D uses component 2 only

    @property
    def num_bodies(self) -> int:
        return self.object_ids.shape[0]


def rigid_to_host(rigid: RigidState) -> dict[str, np.ndarray]:
    """Host copy as a dict of numpy arrays keyed by field name (the fields
    of ``tisph_tpu.models.rigid.RigidState``)."""
    return {k: getattr(rigid, k).cpu().numpy() for k in _RIGID_FIELDS}


def rigid_from_host(d: dict[str, np.ndarray], device: str | torch.device) -> RigidState:
    """RigidState on ``device`` from a :func:`rigid_to_host` dict of either
    package; dtypes must match."""
    fields = {}
    for k, want in _RIGID_FIELDS.items():
        a = np.asarray(d[k])
        if a.dtype != want:
            raise ValueError(f"field {k!r} has dtype {a.dtype}, expected {np.dtype(want)}")
        fields[k] = torch.tensor(a, device=device)  # a copy: never aliases d
    k = fields["object_ids"].shape[0]
    dim = fields["com"].shape[1] if fields["com"].ndim == 2 else -1
    if (fields["mass"].shape != (k,) or dim not in (2, 3)
            or fields["v_com"].shape != (k, dim) or fields["omega"].shape != (k, 3)):
        raise ValueError("rigid fields have inconsistent shapes: "
                         + ", ".join(f"{n} {tuple(t.shape)}" for n, t in fields.items()))
    return RigidState(**fields)


def make_rigid_state(state: SimState, scene: SceneConfig) -> RigidState:
    """Bodies of the scene's ``rigidBodies`` with ``isDynamic``; body k of
    the scene has object id k (``geometry.builder`` adds bodies first).
    Mass and COM from the initial particles (one read back to the host),
    at rest."""
    dyn_ids = [k for k, rb in enumerate(scene.rigid_bodies) if rb.is_dynamic]
    if not dyn_ids:
        raise ValueError("scene has no dynamic rigid bodies")
    host_oid = state.object_id.cpu().numpy()
    host_m = state.mass.cpu().numpy()
    host_x = state.x.cpu().numpy()
    host_mat = state.material.cpu().numpy()
    coms, masses = [], []
    for k in dyn_ids:
        sel = (host_oid == k) & (host_mat == MATERIAL_BOUNDARY)
        if not sel.any():
            raise ValueError(f"dynamic body {k} has no particles")
        m = host_m[sel]
        coms.append((host_x[sel] * m[:, None]).sum(0) / m.sum())
        masses.append(m.sum())
    k, dim, dev = len(dyn_ids), state.dim, state.device
    return RigidState(
        object_ids=torch.tensor(dyn_ids, dtype=torch.int32, device=dev),
        mass=torch.tensor(np.asarray(masses, np.float32), device=dev),
        com=torch.tensor(np.stack(coms).astype(np.float32), device=dev),
        v_com=torch.zeros((k, dim), dtype=torch.float32, device=dev),
        omega=torch.zeros((k, 3), dtype=torch.float32, device=dev),
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis of (..., 3) tensors."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _pad3(a: torch.Tensor) -> torch.Tensor:
    """(..., dim) -> (..., 3), zero-padded (2D lies in the xy plane)."""
    if a.shape[-1] == 3:
        return a
    return torch.nn.functional.pad(a, (0, 3 - a.shape[-1]))


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 3) x (3, 3) in plain f32 multiplies and adds, so no
    TF32 setting can change it."""
    return (a[..., :, None] * b).sum(-2)


def _eye3(device: torch.device) -> torch.Tensor:
    """The 3x3 identity, copied to ``device`` once."""
    return device_constant((1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
                           torch.float32, device).view(3, 3)


def _rotation_matrix(phi3: torch.Tensor) -> torch.Tensor:
    """Exact rotation matrix of the rotation vector ``phi3`` (Rodrigues):
    R = I + (sin t / t) [phi]x + ((1 - cos t) / t^2) [phi]x^2, with the
    series of both coefficients below t = 1e-4."""
    t2 = torch.sum(phi3 * phi3)
    t = torch.sqrt(t2)
    small = t < 1e-4
    one = torch.ones_like(t)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / torch.where(small, one, t))
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / torch.where(small, one, t2))
    zero = torch.zeros_like(t)
    k = torch.stack([
        torch.stack([zero, -phi3[2], phi3[1]]),
        torch.stack([phi3[2], zero, -phi3[0]]),
        torch.stack([-phi3[1], phi3[0], zero]),
    ])
    eye = _eye3(phi3.device)
    return eye + a * k + b * _matmul3(k, k)


def integrate_rigid(state: SimState, rigid: RigidState, reactions: torch.Tensor,
                    params: SolverParams) -> tuple[SimState, RigidState]:
    """:func:`integrate_rigid_fields` on a SimState."""
    x, v, rigid2 = integrate_rigid_fields(state.x, state.v, state.mass, state.object_id,
                                          state.boundary_mask, rigid, reactions, params)
    return dataclasses.replace(state, x=x, v=v), rigid2


def integrate_rigid_fields(
    x: torch.Tensor,              # (N, dim)
    v: torch.Tensor,              # (N, dim)
    mass: torch.Tensor,           # (N,)
    object_id: torch.Tensor,      # (N,) i32
    boundary_mask: torch.Tensor,  # (N,) bool
    rigid: RigidState,
    reactions: torch.Tensor,      # (N, dim) fluid -> boundary forces
    params: SolverParams,
) -> tuple[torch.Tensor, torch.Tensor, RigidState]:
    """One symplectic step of every dynamic body and its particles; returns
    (x, v, rigid) with only body rows of x and v changed."""
    sums = [body_sums(x, mass, object_id, boundary_mask, rigid, reactions, k, params)
            for k in range(rigid.num_bodies)]
    rigid2, moves = step_bodies(rigid, sums, params, x.shape[1])
    x, v = move_body_rows(x, v, object_id, boundary_mask, rigid, moves)
    return x, v, rigid2


def body_sums(x, mass, object_id, boundary_mask, rigid: RigidState, reactions,
              k: int, params: SolverParams) -> tuple[torch.Tensor, ...]:
    """Body k's sums over the rows given: (force, torque, inertia, pen_lo,
    pen_hi), the net reaction force (dim,), its torque about the COM (3,),
    the inertia of the particles about the COM (3, 3), and the deepest
    penetration below and above the padded domain box (dim,) each.  The
    first three add over disjoint sets of rows, the last two combine by
    max: a sharded solver adds its shards' sums."""
    lo, hi = domain_box(params, x.device)
    eye = _eye3(x.device)
    mask = (object_id == rigid.object_ids[k]) & boundary_mask  # (N,)
    maskf = mask.to(torch.float32)[:, None]
    m_p = mass * maskf[:, 0]

    com = rigid.com[k]
    r = (x - com) * maskf  # zero off the body
    f_p = reactions * maskf
    force = torch.sum(f_p, dim=0)
    tau3 = torch.sum(_cross(_pad3(r), _pad3(f_p)), dim=0)

    # inertia of the current particles about the COM
    r3 = _pad3(r)
    r2 = torch.sum(r3 * r3, dim=-1)
    inertia = torch.sum(
        m_p[:, None, None] * (r2[:, None, None] * eye - r3[:, :, None] * r3[:, None, :]),
        dim=0,
    )
    # wall contact: the deepest penetration of the padded box
    body_x = torch.where(maskf > 0, x, com)  # off-body rows at the COM
    pen_lo = torch.amax(torch.clamp(lo - body_x, min=0.0), dim=0)
    pen_hi = torch.amax(torch.clamp(body_x - hi, min=0.0), dim=0)
    return force, tau3, inertia, pen_lo, pen_hi


def step_bodies(rigid: RigidState, sums, params: SolverParams,
                dim: int) -> tuple[RigidState, list[tuple[torch.Tensor, ...]]]:
    """The bodies' new state from their :func:`body_sums` (one tuple per
    body), and per body what :func:`move_body_rows` applies to its rows."""
    dev = rigid.com.device
    dt = params.dt
    # constants copied to the device once, never per substep
    g = device_constant(params.gravity, torch.float32, dev)
    eye = _eye3(dev)
    new_com, new_vcom, new_omega, moves = [], [], [], []
    for k, (fsum, tau3, isum, pen_lo, pen_hi) in enumerate(sums):
        force = fsum + rigid.mass[k] * g
        inertia = isum + 1e-8 * eye
        if dim == 2:  # planar rotation: omega_z += dt tau_z / I_zz
            zero = torch.zeros_like(tau3[2])
            domega = torch.stack([zero, zero, tau3[2] / inertia[2, 2]])
        else:  # solve_ex: no host sync for an error check
            domega = torch.linalg.solve_ex(inertia, tau3)[0]

        v_com = rigid.v_com[k] + dt * force / rigid.mass[k]
        omega = rigid.omega[k] + dt * domega

        # wall contact: push back the deepest penetration, reflect v_com
        shift = pen_lo - pen_hi
        hit = (pen_lo > 0) | (pen_hi > 0)
        v_com = torch.where(hit, -params.collision_factor * v_com, v_com)
        new_c = rigid.com[k] + dt * v_com + shift
        moves.append((new_c, v_com, omega, _rotation_matrix(omega * dt)))
        new_com.append(new_c)
        new_vcom.append(v_com)
        new_omega.append(omega)

    rigid2 = RigidState(
        object_ids=rigid.object_ids,
        mass=rigid.mass,
        com=torch.stack(new_com),
        v_com=torch.stack(new_vcom),
        omega=torch.stack(new_omega),
    )
    return rigid2, moves


def move_body_rows(x, v, object_id, boundary_mask, rigid: RigidState,
                   moves) -> tuple[torch.Tensor, torch.Tensor]:
    """x and v with every body's rows moved rigidly: v_p = v_com + omega x
    r, offsets r about the old COM (of ``rigid``) rotated exactly about the
    new one.  ``moves`` from :func:`step_bodies`, on x's device."""
    dim = x.shape[1]
    for k, (new_c, v_com, omega, rot) in enumerate(moves):
        mask = (object_id == rigid.object_ids[k]) & boundary_mask
        r_cur = _pad3(x - rigid.com[k])
        v_rot = _cross(omega.expand(x.shape[0], 3), r_cur)[:, :dim]
        v_p = v_com + v_rot
        x_p = new_c + _matmul3(r_cur, rot.T)[:, :dim]
        x = torch.where(mask[:, None], x_p, x)
        v = torch.where(mask[:, None], v_p, v)
    return x, v
