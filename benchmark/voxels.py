"""The benchmark's own voxelizer of a scene's ``rigidBodies``: a body's
rows as Ti-SPH makes them, ``mesh.voxelized(pitch).fill().points`` at the
particle diameter, from the scene schema alone (numpy and scipy, no code
of the program).

- The mesh: a Wavefront OBJ file (``v`` and ``f`` records; a polygon is
  a fan of triangles from its first corner; ``v/vt/vn`` indices take the
  vertex, a negative index counts back from the last vertex read).
- Its placement, in the schema's order: each coordinate times ``scale``
  (three factors, or the first for all three), then the turn by
  ``rotationAngle`` degrees about ``rotationAxis`` through the mean of the
  vertices (none at an angle of 0), then ``translation``.
- The surface's voxels: trimesh's ``voxelized``: every triangle split at
  its edges' midpoints into four, again and again, until no edge of it is
  longer than pitch / 2; the voxel of each corner of those triangles is
  marked.
- The fill: every voxel that no 6-connected path of unmarked voxels joins
  to the outside of the grid is added (``fill``).
- The points: the grid's origin lies one pitch below the mesh's lower
  bound on each axis, voxel (i, j, k) covers origin + [i, i + 1) pitch
  (and so on), a point is a filled voxel's centre, origin + (index + 1/2)
  pitch, rounded to float32, in C order of the indices.

Only closed meshes (every edge shared by exactly two triangles) are
taken: an open mesh has no inside to fill, and a voxelizer that closes it
some way of its own would make another body.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy import ndimage


def read_obj(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float64, triangles (F, 3) int64) of an OBJ file."""
    verts: list[list[float]] = []
    tris: list[list[int]] = []
    with open(path) as f:
        for line in f:
            words = line.split()
            if not words:
                continue
            if words[0] == "v":
                verts.append([float(w) for w in words[1:4]])
            elif words[0] == "f":
                corners = []
                for w in words[1:]:
                    k = int(w.split("/")[0])
                    corners.append(k - 1 if k > 0 else len(verts) + k)
                tris += [[corners[0], corners[a], corners[a + 1]]
                         for a in range(1, len(corners) - 1)]
    return np.asarray(verts, np.float64).reshape(-1, 3), np.asarray(tris, np.int64).reshape(-1, 3)


def turn(angle_deg: float, axis) -> np.ndarray:
    """The 3x3 matrix of the turn by ``angle_deg`` about ``axis``
    (right-handed), from the axis's unit vector u: cos I + sin [u]x +
    (1 - cos) u u^T."""
    u = np.asarray(axis, np.float64)
    u = u / np.linalg.norm(u)
    a = np.deg2rad(angle_deg)
    cross = np.array([[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]])
    return np.cos(a) * np.eye(3) + np.sin(a) * cross + (1.0 - np.cos(a)) * np.outer(u, u)


def placed(verts: np.ndarray, body: dict) -> np.ndarray:
    """The vertices scaled, turned about their mean and moved as the
    ``rigidBodies`` entry ``body`` says."""
    scale = [float(s) for s in body.get("scale", [1.0, 1.0, 1.0])]
    out = verts * np.asarray(scale if len(scale) == 3 else scale[0], np.float64)
    angle = float(body.get("rotationAngle", 0.0))
    if angle:
        centre = out.mean(axis=0)
        out = (out - centre) @ turn(angle, body.get("rotationAxis", [0.0, 1.0, 0.0])).T + centre
    return out + np.asarray([float(t) for t in body.get("translation", [0.0, 0.0, 0.0])],
                            np.float64)


def _closed(tris: np.ndarray) -> bool:
    """Every undirected edge shared by exactly two triangles."""
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
    _, uses = np.unique(edges, axis=0, return_counts=True)
    return bool(len(tris)) and bool((uses == 2).all())


def surface_corners(verts: np.ndarray, tris: np.ndarray, pitch: float) -> np.ndarray:
    """The corners of the triangles left when every triangle is split
    into four at its edges' midpoints until its longest edge is at most
    pitch / 2: (P, 3), with repeats."""
    live = verts[tris]  # (F, 3 corners, 3)
    cut2 = (0.5 * pitch) ** 2
    kept = []
    while len(live):
        a, b, c = live[:, 0], live[:, 1], live[:, 2]
        longest2 = np.maximum(np.maximum(((a - b) ** 2).sum(-1), ((b - c) ** 2).sum(-1)),
                              ((c - a) ** 2).sum(-1))
        small = longest2 <= cut2
        kept.append(live[small].reshape(-1, 3))
        a, b, c = a[~small], b[~small], c[~small]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        live = np.concatenate([np.stack(t, axis=1) for t in
                               ((a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))])
    return np.concatenate(kept)


def body_points(body: dict, pitch: float, base_dir: str | Path) -> np.ndarray:
    """The rows of the ``rigidBodies`` entry ``body`` at ``pitch``: (P, 3)
    float32 voxel centres, C order (the module's docstring)."""
    path = Path(body["geometryFile"])
    verts, tris = read_obj(path if path.is_absolute() else Path(base_dir) / path)
    if not _closed(tris):
        raise ValueError(f"{path}: the benchmark voxelizes closed meshes only")
    verts = placed(verts, body)
    origin = verts.min(axis=0) - pitch
    index = np.floor((surface_corners(verts, tris, pitch) - origin) / pitch).astype(np.int64)
    marked = np.zeros(tuple(index.max(axis=0) + 2), bool)
    marked[tuple(index.T)] = True
    # one empty layer on every side, so the outside wraps the whole surface
    solid = ndimage.binary_fill_holes(np.pad(marked, 1))[1:-1, 1:-1, 1:-1]
    return (origin + (np.argwhere(solid) + 0.5) * pitch).astype(np.float32)
