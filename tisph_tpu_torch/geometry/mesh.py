"""Triangle meshes for rigid bodies (numpy only).

The same functions and numerics as ``tisph_tpu.geometry.mesh``: OBJ
parsing, scale / rotate about the vertex centroid / translate (the
reference's trimesh pipeline, partice_systemv4.py:259-277), and two
procedural meshes for tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray     # (F, 3) int32 triangle indices

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.faces.copy())

    @property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def apply_scale(self, scale: Sequence[float] | float) -> "TriMesh":
        self.vertices = self.vertices * np.asarray(scale, dtype=np.float64)
        return self

    def apply_translation(self, offset: Sequence[float]) -> "TriMesh":
        self.vertices = self.vertices + np.asarray(offset, dtype=np.float64)
        return self

    def apply_rotation(
        self, angle_deg: float, axis: Sequence[float], point: Sequence[float] | None = None
    ) -> "TriMesh":
        """Rotate about ``axis`` through ``point`` (default: the vertex
        centroid, as the reference rotates)."""
        if point is None:
            point = self.vertices.mean(axis=0)
        point = np.asarray(point, dtype=np.float64)
        rot = rotation_matrix(np.deg2rad(angle_deg), axis)
        self.vertices = (self.vertices - point) @ rot.T + point
        return self


def rotation_matrix(angle_rad: float, axis: Sequence[float]) -> np.ndarray:
    """Rodrigues rotation matrix about a (normalised) axis."""
    a = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(a)
    if n < 1e-12:
        return np.eye(3)
    x, y, z = a / n
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


def load_obj(path: str | os.PathLike) -> TriMesh:
    """Parse a Wavefront OBJ: ``v`` and ``f`` records, polygons
    fan-triangulated, ``v/vt/vn`` slash syntax and negative indices."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(
        vertices=np.asarray(verts, dtype=np.float64),
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


def box_mesh(lo: Sequence[float], hi: Sequence[float]) -> TriMesh:
    """Axis-aligned box, 12 triangles."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    corners = np.array(
        [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
         [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]]
    )
    faces = np.array(
        [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
         [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
         [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]],
        dtype=np.int32,
    )
    return TriMesh(corners, faces)


def sphere_mesh(center: Sequence[float], radius: float, subdiv: int = 2) -> TriMesh:
    """Icosphere: an icosahedron subdivided ``subdiv`` times."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        dtype=np.float64,
    )
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int32,
    )
    for _ in range(subdiv):
        new_faces = []
        mid_cache: dict[tuple[int, int], int] = {}
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in mid_cache:
                verts_list.append((verts_list[a] + verts_list[b]) / 2.0)
                mid_cache[key] = len(verts_list) - 1
            return mid_cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int32)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return TriMesh(verts + np.asarray(center, dtype=np.float64), faces)


def save_obj(mesh: TriMesh, path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
