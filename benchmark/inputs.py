"""The start state S0 of a configuration, made by the benchmark from the
scene file and the seed, and handed to the program.

The lattice is Ti-SPH's ``add_cube``: per axis ``arange(start, end,
spacing)``, an ij meshgrid, rounded to float32, spacing the particle
radius unless a fluid block sets its own.  A ``boundaryBlocks`` entry is
the scene schema's static boundary box: a lattice at the particle
diameter, material 0, at rest, with the block's density and colour.  A
``rigidBodies`` entry is a mesh filled with voxels at the particle
diameter (``benchmark.voxels``, imported only for a scene that has
bodies): material 0, with the body's velocity, density and colour; a
body with ``isDynamic`` moves with the fluid, the others stay put.  The
rows come as the program's ``build_state`` orders them, the bodies, then
the boundary blocks, then the fluid blocks, each with the volume 0.8
d^dim and the mass volume * density that it sets (the program replaces a
boundary row's volume by its Akinci volume when it binds the state, or
in every step where bodies move).

``--seed`` moves each coordinate of a fluid row by a uniform draw in
[-a, a] times the spacing, ``a`` the configuration's ``jitter``: small
against the spacing, so the flow and the work per step are the same on
every seed while the particles' paths differ; boundary rows stay on
their lattice and bodies where they are placed.

Every row gets a tag in ``object_id``, which the program carries through
its sorts and the check matches rows by: a dynamic body's rows keep the
body's index in ``rigidBodies``, which is how the coupled step finds
them (and the check matches them by position, within their body); every
other row gets its start row plus the number of bodies, which is no
body's index.  Without bodies a row's tag is its start row.
"""

from __future__ import annotations

import numpy as np


# what a scene may hold that the benchmark cannot make yet, and why
REFUSED = {
    "emitters": "emission into the pool of dead rows, in the inputs and in the reference",
}


def _color(block: dict) -> np.ndarray:
    """A block's colour as three float32s, 0-255 values scaled to 0-1."""
    color = np.asarray(block.get("color", [0.2, 0.4, 0.8]), dtype=np.float64)[:3]
    if color.max(initial=0.0) > 1.0:
        color = color / 255.0
    return color.astype(np.float32)


def dynamic_bodies(scene: dict) -> list[int]:
    """The indices in ``rigidBodies`` of the bodies with ``isDynamic``:
    the tags of their rows, in the order of the program's body state."""
    return [k for k, b in enumerate(scene.get("rigidBodies") or []) if b.get("isDynamic")]


def lattice(scene: dict, base_dir=None) -> dict[str, np.ndarray]:
    """The bodies, boundary and fluid blocks of a scene file as host
    arrays, in the program's field names, before any jitter; a body's
    ``geometryFile`` is found from ``base_dir``, the scene file's folder."""
    cfg = scene["configuration"]
    dim = int(cfg.get("dim", len(cfg["domainStart"])))
    for key, lacks in REFUSED.items():
        if scene.get(key):
            raise NotImplementedError(f"the benchmark cannot make a scene's {key}: it lacks "
                                      f"{lacks}")
    radius = float(cfg["particleRadius"])
    volume0 = 0.8 * (2.0 * radius) ** dim
    parts = {k: [] for k in ("x", "v", "density", "color", "material")}
    bodies = scene.get("rigidBodies") or []
    if bodies:
        if dim != 3 or base_dir is None:
            raise NotImplementedError("the benchmark makes rigid bodies in 3D scenes, with "
                                      "the scene file's folder to find their meshes")
        from benchmark import voxels

        for body in bodies:
            x = voxels.body_points(body, 2.0 * radius, base_dir)
            n = x.shape[0]
            parts["x"].append(x)
            parts["v"].append(np.tile(np.asarray(body.get("velocity", [0.0] * dim)[:dim],
                                                 dtype=np.float32), (n, 1)))
            parts["density"].append(np.full(n, float(body.get("density", 1000.0) or 1000.0),
                                            np.float32))
            parts["color"].append(np.tile(_color(body), (n, 1)))
            parts["material"].append(np.zeros(n, np.int32))
    for block in scene.get("boundaryBlocks") or []:
        axes = [np.arange(float(s), float(e), 2.0 * radius)
                for s, e in zip(block["start"][:dim], block["end"][:dim])]
        grid = np.meshgrid(*axes, indexing="ij")
        x = np.stack([g.ravel() for g in grid], axis=-1).astype(np.float32)
        n = x.shape[0]
        parts["x"].append(x)
        parts["v"].append(np.zeros((n, dim), np.float32))
        parts["density"].append(np.full(n, float(block.get("density", 1000.0)), np.float32))
        parts["color"].append(np.tile(_color(block), (n, 1)))
        parts["material"].append(np.zeros(n, np.int32))
    for block in scene["fluidBlocks"]:
        start = np.asarray(block["start"][:dim], dtype=np.float64)
        end = np.asarray(block["end"][:dim], dtype=np.float64)
        if block.get("scale"):
            end = start + (end - start) * np.asarray(block["scale"][:dim], dtype=np.float64)
        spacing = block.get("spacing") or radius
        if spacing == "diameter":
            spacing = 2.0 * radius
        axes = [np.arange(s, e, spacing) for s, e in zip(start, end)]
        grid = np.meshgrid(*axes, indexing="ij")
        x = np.stack([g.ravel() for g in grid], axis=-1).astype(np.float32)
        if block.get("translation"):
            x = x + np.asarray(block["translation"][:dim], dtype=np.float32)
        n = x.shape[0]
        parts["x"].append(x)
        parts["v"].append(np.tile(np.asarray(block.get("velocity", [0.0] * dim)[:dim],
                                             dtype=np.float32), (n, 1)))
        parts["density"].append(np.full(n, float(block.get("density", 1000.0)), np.float32))
        parts["color"].append(np.tile(_color(block), (n, 1)))
        parts["material"].append(np.ones(n, np.int32))
    out = {k: np.concatenate(v) for k, v in parts.items()}
    n = out["x"].shape[0]
    out["pressure"] = np.zeros(n, np.float32)
    out["volume"] = np.full(n, volume0, np.float32)
    out["mass"] = out["volume"] * out["density"]
    out["object_id"] = np.arange(len(bodies), n + len(bodies), dtype=np.int32)
    start = 0
    for k, x in enumerate(parts["x"][:len(bodies)]):
        if bodies[k].get("isDynamic"):
            out["object_id"][start:start + len(x)] = k
        start += len(x)
    out["num_active"] = np.asarray(n)
    return out


def spacing(scene: dict) -> float:
    """The lattice spacing of the scene's first fluid block."""
    block, radius = scene["fluidBlocks"][0], float(scene["configuration"]["particleRadius"])
    sp = block.get("spacing") or radius
    return 2.0 * radius if sp == "diameter" else float(sp)


def start_state(scene: dict, jitter: float, seed: int, base_dir=None
                ) -> dict[str, np.ndarray]:
    """S0: the lattice with each coordinate of a fluid row moved by
    U[-jitter, jitter] times the spacing, drawn from ``seed``."""
    s0 = lattice(scene, base_dir)
    fluid = s0["material"] == 1
    rng = np.random.default_rng(seed)
    move = rng.uniform(-jitter, jitter, size=s0["x"][fluid].shape) * spacing(scene)
    s0["x"][fluid] = (s0["x"][fluid].astype(np.float64) + move).astype(np.float32)
    return s0
