"""The start state S0 of a configuration, made by the benchmark from the
scene file and the seed, and handed to the program.

The lattice is Ti-SPH's ``add_cube``: per axis ``arange(start, end,
spacing)``, an ij meshgrid, rounded to float32, spacing the particle
radius unless a block sets its own.  ``--seed`` moves each coordinate by
a uniform draw in [-a, a] times the spacing, ``a`` the configuration's
``jitter``: small against the spacing, so the flow and the work per step
are the same on every seed while the particles' paths differ.  Every row
gets its start row as ``object_id``, its tag: the program carries the
tag through its sorts, and the check matches rows by it.
"""

from __future__ import annotations

import numpy as np


def lattice(scene: dict) -> dict[str, np.ndarray]:
    """The fluid blocks of a scene file as host arrays, in the program's
    field names, before any jitter."""
    cfg = scene["configuration"]
    dim = int(cfg.get("dim", len(cfg["domainStart"])))
    for key in ("rigidBodies", "boundaryBlocks", "emitters"):
        if scene.get(key):
            raise NotImplementedError(f"the benchmark's scenes hold fluid blocks only, "
                                      f"not {key}")
    radius = float(cfg["particleRadius"])
    volume0 = 0.8 * (2.0 * radius) ** dim
    parts = {k: [] for k in ("x", "v", "density", "color")}
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
        color = np.asarray(block.get("color", [0.2, 0.4, 0.8]), dtype=np.float64)[:3]
        if color.max(initial=0.0) > 1.0:
            color = color / 255.0
        parts["x"].append(x)
        parts["v"].append(np.tile(np.asarray(block.get("velocity", [0.0] * dim)[:dim],
                                             dtype=np.float32), (n, 1)))
        parts["density"].append(np.full(n, float(block.get("density", 1000.0)), np.float32))
        parts["color"].append(np.tile(color.astype(np.float32), (n, 1)))
    out = {k: np.concatenate(v) for k, v in parts.items()}
    n = out["x"].shape[0]
    out["pressure"] = np.zeros(n, np.float32)
    out["volume"] = np.full(n, volume0, np.float32)
    out["mass"] = out["volume"] * out["density"]
    out["material"] = np.ones(n, np.int32)
    out["object_id"] = np.arange(n, dtype=np.int32)
    out["num_active"] = np.asarray(n)
    return out


def spacing(scene: dict) -> float:
    """The lattice spacing of the scene's first fluid block."""
    block, radius = scene["fluidBlocks"][0], float(scene["configuration"]["particleRadius"])
    sp = block.get("spacing") or radius
    return 2.0 * radius if sp == "diameter" else float(sp)


def start_state(scene: dict, jitter: float, seed: int) -> dict[str, np.ndarray]:
    """S0: the lattice with each coordinate moved by U[-jitter, jitter]
    times the spacing, drawn from ``seed``."""
    s0 = lattice(scene)
    rng = np.random.default_rng(seed)
    move = rng.uniform(-jitter, jitter, size=s0["x"].shape) * spacing(scene)
    s0["x"] = (s0["x"].astype(np.float64) + move).astype(np.float32)
    return s0
