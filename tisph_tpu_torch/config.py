"""Scene and solver configuration (numpy only).

The same JSON scene schema as ``tisph_tpu.config`` (the reference's
data/scenes/*.json), parsed to the same field values, and the same three
``compat`` presets for :class:`SolverParams`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Sequence

import numpy as np

_DEFAULT_DENSITY0 = 1000.0


@dataclasses.dataclass(frozen=True)
class FluidBlock:
    """Axis-aligned lattice-sampled fluid block (``fluidBlocks`` entry)."""

    start: tuple[float, ...]
    end: tuple[float, ...]
    velocity: tuple[float, ...]
    density: float = _DEFAULT_DENSITY0
    color: tuple[float, float, float] = (0.2, 0.4, 0.8)
    translation: tuple[float, ...] | None = None
    scale: tuple[float, ...] | None = None
    object_id: int = 0
    # lattice spacing; None = particle radius (the reference's convention).
    # JSON key: "spacing" (float) or "spacing": "diameter".
    spacing: float | None = None


@dataclasses.dataclass(frozen=True)
class BoundaryBlock:
    """Lattice-sampled static boundary box, sampled at the particle
    diameter (``boundaryBlocks`` entry)."""

    start: tuple[float, ...]
    end: tuple[float, ...]
    density: float = _DEFAULT_DENSITY0
    color: tuple[float, float, float] = (0.6, 0.6, 0.6)


@dataclasses.dataclass(frozen=True)
class RigidBody:
    """Mesh body voxelized at the particle diameter (``rigidBodies``
    entry).  Static bodies are boundary particles that never move; dynamic
    ones (``isDynamic``) run through ``models.wcsph_rigid.WCSPHRigid``."""

    geometry_file: str
    scale: tuple[float, ...]
    translation: tuple[float, ...]
    rotation_angle: float = 0.0
    rotation_axis: tuple[float, float, float] = (0.0, 1.0, 0.0)
    velocity: tuple[float, ...] = (0.0, 0.0, 0.0)
    density: float = _DEFAULT_DENSITY0
    color: tuple[float, float, float] = (0.6, 0.6, 0.6)
    is_dynamic: bool = False


@dataclasses.dataclass(frozen=True)
class Emitter:
    """Inflow emitter (``emitters`` entry): every ``interval`` solver steps
    it activates a lattice-sampled batch of fluid particles over
    ``[start, end]`` with ``velocity``, drawn from the pre-allocated
    inactive pool (``geometry.emitter``)."""

    start: tuple[float, ...]
    end: tuple[float, ...]
    velocity: tuple[float, ...]
    interval: int = 50
    density: float = _DEFAULT_DENSITY0
    color: tuple[float, float, float] = (0.2, 0.4, 0.8)
    max_particles: int = 0  # 0 => until the pool is exhausted


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Parsed scene: domain, discretisation and bodies.

    Support length = 4 * particle radius, padding = support length,
    particle volume V0 = 0.8 * diameter**dim (the reference's constants).
    """

    dim: int
    domain_start: tuple[float, ...]
    domain_end: tuple[float, ...]
    particle_radius: float
    density0: float = _DEFAULT_DENSITY0
    gravitation: tuple[float, ...] = (0.0, -9.81, 0.0)
    c_s: float = 100.0
    fluid_blocks: tuple[FluidBlock, ...] = ()
    rigid_bodies: tuple[RigidBody, ...] = ()
    boundary_blocks: tuple[BoundaryBlock, ...] = ()
    emitters: tuple[Emitter, ...] = ()
    # Keys the reference parses but ignores; honored under compat="config".
    stiffness_B: float | None = None
    gamma: float | None = None
    dt: float | None = None
    viscosity: float | None = None
    surface_tension: float | None = None
    collision_factor: float | None = None
    steps_per_render: int = 1
    simulation_method: int = 0
    output_interval: int = 40
    # directory of the scene file; relative geometryFile paths resolve here
    base_dir: str = "."

    @property
    def support_length(self) -> float:
        return 4.0 * self.particle_radius

    @property
    def particle_diameter(self) -> float:
        return 2.0 * self.particle_radius

    @property
    def padding(self) -> float:
        return self.support_length

    @property
    def particle_volume0(self) -> float:
        return 0.8 * self.particle_diameter**self.dim

    @property
    def domain_size(self) -> tuple[float, ...]:
        return tuple(e - s for s, e in zip(self.domain_start, self.domain_end))


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Resolved physics parameters: Python scalars only."""

    dim: int
    dt: float = 2e-4
    density0: float = _DEFAULT_DENSITY0
    stiffness: float = 50.0
    exponent: float = 7.0
    viscosity: float = 0.05
    surface_tension: float = 0.01
    boundary_sigma: float = 0.08
    collision_factor: float = 0.5
    c_s: float = 100.0
    # compat="reference-exact": replay the reference's V2 density bug
    # (see ops.forces.apply_density_mode).
    reference_exact: bool = False
    gravity: tuple[float, ...] = (0.0, -9.81, 0.0)
    support_length: float = 0.04
    particle_radius: float = 0.01
    padding: float = 0.04
    domain_start: tuple[float, ...] = (0.0, 0.0, 0.0)
    domain_end: tuple[float, ...] = (1.0, 1.0, 1.0)

    @classmethod
    def from_scene(cls, scene: SceneConfig, compat: str = "reference") -> "SolverParams":
        """``compat="reference"``: the constants the reference hardcodes;
        ``"config"``: the scene's own keys where given;
        ``"reference-exact"``: reference constants plus the density bug."""
        if compat not in ("reference", "config", "reference-exact"):
            raise ValueError(f"unknown compat preset: {compat!r}")
        use_cfg = compat == "config"

        def pick(cfg_val, ref_val):
            return ref_val if (not use_cfg or cfg_val is None) else cfg_val

        return cls(
            dim=scene.dim,
            dt=pick(scene.dt, 2e-4),
            density0=scene.density0,
            stiffness=pick(scene.stiffness_B, 50.0),
            exponent=pick(scene.gamma, 7.0),
            viscosity=pick(scene.viscosity, 0.05),
            surface_tension=pick(scene.surface_tension, 0.01),
            boundary_sigma=0.08,
            reference_exact=compat == "reference-exact",
            collision_factor=pick(scene.collision_factor, 0.5),
            c_s=scene.c_s,
            gravity=tuple(scene.gravitation[: scene.dim]),
            support_length=scene.support_length,
            particle_radius=scene.particle_radius,
            padding=scene.padding,
            domain_start=scene.domain_start,
            domain_end=scene.domain_end,
        )


def _tup(v: Sequence[float] | None, dim: int, default: float = 0.0) -> tuple[float, ...]:
    if v is None:
        return (default,) * dim
    return tuple(float(x) for x in v)


def _color(v: Any) -> tuple[float, float, float]:
    if v is None:
        return (0.2, 0.4, 0.8)
    arr = np.asarray(v, dtype=np.float64).reshape(-1)[:3]
    # 0-255 colors are normalised, as the reference does.
    if arr.max(initial=0.0) > 1.0:
        arr = arr / 255.0
    return tuple(float(x) for x in arr)


def _span(block: dict, what: str, dim: int) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """A block's ``start`` and ``end``, cut to ``dim`` entries; a vector
    shorter than ``dim`` raises (the reference takes the shorter length
    and the run fails later in the cell binning)."""
    for key in ("start", "end"):
        if len(block[key]) < dim:
            raise ValueError(f"{what}: {key} has {len(block[key])} entries, the scene's dim "
                             f"is {dim}")
    return _tup(block["start"][:dim], dim), _tup(block["end"][:dim], dim)


def scene_from_dict(raw: dict[str, Any], base_dir: str = ".") -> SceneConfig:
    """Build a :class:`SceneConfig` from the reference JSON schema dict."""
    cfg = raw.get("configuration", {})
    # dim defaults to the length of domainStart; 2D scenes may declare a
    # 3-vector domain, which is truncated.
    dom_start = cfg.get("domainStart", [0.0, 0.0, 0.0])
    dim = int(cfg.get("dim", len(dom_start)))
    dom_start = _tup(dom_start[:dim], dim)
    dom_end = _tup(cfg.get("domainEnd", [1.0] * dim)[:dim], dim)

    pr = float(cfg.get("particleRadius", 0.01))
    fluid_blocks = []
    for i, fb in enumerate(raw.get("fluidBlocks", []) or []):
        start, end = _span(fb, f"fluidBlocks[{i}]", dim)
        sp = fb.get("spacing")
        if sp == "diameter":
            sp = 2.0 * pr
        fluid_blocks.append(
            FluidBlock(
                start=start,
                end=end,
                velocity=_tup(fb.get("velocity"), dim),
                density=float(fb.get("density", _DEFAULT_DENSITY0) or _DEFAULT_DENSITY0),
                color=_color(fb.get("color")),
                translation=_tup(fb["translation"][:dim], dim) if fb.get("translation") else None,
                scale=_tup(fb["scale"][:dim], dim) if fb.get("scale") else None,
                object_id=int(fb.get("objectId", 0)),
                spacing=float(sp) if sp is not None else None,
            )
        )

    rigid_bodies = []
    for rb in raw.get("rigidBodies", []) or []:
        rigid_bodies.append(
            RigidBody(
                geometry_file=str(rb["geometryFile"]),
                scale=_tup(rb.get("scale", [1.0] * dim), dim, 1.0),
                translation=_tup(rb.get("translation"), dim),
                rotation_angle=float(rb.get("rotationAngle", 0.0)),
                rotation_axis=tuple(float(x) for x in rb.get("rotationAxis", [0.0, 1.0, 0.0])),
                velocity=_tup(rb.get("velocity"), dim),
                density=float(rb.get("density", _DEFAULT_DENSITY0) or _DEFAULT_DENSITY0),
                color=_color(rb.get("color")),
                is_dynamic=bool(rb.get("isDynamic", False)),
            )
        )

    boundary_blocks = []
    for i, bb in enumerate(raw.get("boundaryBlocks", []) or []):
        start, end = _span(bb, f"boundaryBlocks[{i}]", dim)
        boundary_blocks.append(
            BoundaryBlock(
                start=start,
                end=end,
                density=float(bb.get("density", _DEFAULT_DENSITY0)),
                color=_color(bb.get("color")),
            )
        )

    emitters = []
    for i, em in enumerate(raw.get("emitters", []) or []):
        start, end = _span(em, f"emitters[{i}]", dim)
        emitters.append(
            Emitter(
                start=start,
                end=end,
                velocity=_tup(em.get("velocity"), dim),
                interval=int(em.get("interval", 50)),
                density=float(em.get("density", _DEFAULT_DENSITY0)),
                color=_color(em.get("color")),
                max_particles=int(em.get("maxParticles", 0)),
            )
        )

    grav = cfg.get("gravitation")
    if grav is None:
        grav = [0.0, -9.81, 0.0]
    return SceneConfig(
        dim=dim,
        domain_start=dom_start,
        domain_end=dom_end,
        particle_radius=pr,
        density0=float(cfg.get("density0", _DEFAULT_DENSITY0)),
        gravitation=tuple(float(g) for g in grav),
        c_s=float(cfg.get("c_s", 100.0)),
        fluid_blocks=tuple(fluid_blocks),
        rigid_bodies=tuple(rigid_bodies),
        boundary_blocks=tuple(boundary_blocks),
        emitters=tuple(emitters),
        stiffness_B=float(cfg["B"]) if "B" in cfg else None,
        gamma=float(cfg["gamma"]) if "gamma" in cfg else None,
        dt=float(cfg["dt"]) if "dt" in cfg else None,
        viscosity=float(cfg["viscosity"]) if "viscosity" in cfg else None,
        surface_tension=float(cfg["surfaceTension"]) if "surfaceTension" in cfg else None,
        collision_factor=float(cfg["collisionFactor"]) if "collisionFactor" in cfg else None,
        steps_per_render=int(cfg.get("numberOfStepsPerRenderUpdate", 1)),
        simulation_method=int(cfg.get("simulationMethod", 0)),
        output_interval=int(cfg.get("outputInterval", 40)),
        base_dir=base_dir,
    )


def load_scene(path: str | os.PathLike) -> SceneConfig:
    """Load a scene JSON file in the reference schema."""
    path = os.fspath(path)
    with open(path) as f:
        raw = json.load(f)
    return scene_from_dict(raw, base_dir=os.path.dirname(os.path.abspath(path)))
