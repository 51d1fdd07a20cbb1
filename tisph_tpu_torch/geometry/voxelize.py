"""Solid mesh voxelization (numpy and ``scipy.ndimage``).

The same algorithm and output as ``tisph_tpu.geometry.voxelize``, in
place of the reference's ``mesh.voxelized(pitch).fill().points``:

1. rasterise the triangle surface onto a grid of ``pitch`` by recursive
   triangle subdivision (every voxel the surface passes within about
   pitch/2 of is marked);
2. flood-fill the exterior from the grid's border (6-connectivity);
3. filled = surface | ~exterior; the particles are the voxel centers.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from tisph_tpu_torch.geometry.mesh import TriMesh


def _rasterize_surface(mesh: TriMesh, origin: np.ndarray, pitch: float,
                       shape: tuple[int, ...]) -> np.ndarray:
    """Mark every voxel a triangle touches: subdivide triangles until
    every edge is at most pitch/2, then bin their corners."""
    occ = np.zeros(shape, dtype=bool)
    stack = [mesh.vertices[mesh.faces]]  # (F, 3, 3)
    target = pitch * 0.5
    while stack:
        t = stack.pop()
        if t.size == 0:
            continue
        e0 = np.linalg.norm(t[:, 0] - t[:, 1], axis=1)
        e1 = np.linalg.norm(t[:, 1] - t[:, 2], axis=1)
        e2 = np.linalg.norm(t[:, 2] - t[:, 0], axis=1)
        small = np.maximum(e0, np.maximum(e1, e2)) <= target
        done = t[small]
        if done.size:
            idx = np.floor((done.reshape(-1, 3) - origin) / pitch).astype(np.int64)
            np.clip(idx, 0, np.asarray(shape) - 1, out=idx)
            occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        big = t[~small]
        if big.size:
            a, b, c = big[:, 0], big[:, 1], big[:, 2]
            ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
            stack.append(np.stack([a, ab, ca], axis=1))
            stack.append(np.stack([b, bc, ab], axis=1))
            stack.append(np.stack([c, ca, bc], axis=1))
            stack.append(np.stack([ab, bc, ca], axis=1))
    return occ


def _flood_fill(surface: np.ndarray) -> np.ndarray:
    """surface | interior, the exterior being the components of the
    complement that touch the grid's border."""
    labels, _ = ndimage.label(~surface, structure=ndimage.generate_binary_structure(3, 1))
    border = np.unique(np.concatenate(
        [labels[0].ravel(), labels[-1].ravel(),
         labels[:, 0].ravel(), labels[:, -1].ravel(),
         labels[:, :, 0].ravel(), labels[:, :, -1].ravel()]
    ))
    exterior = np.isin(labels, border[border != 0])
    return surface | ~exterior


def voxelize_solid(mesh: TriMesh, pitch: float,
                   max_close_iters: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(filled mask, grid origin).  A mesh with holes lets the exterior
    flood leak inside and leaves no interior; the shell is then closed
    morphologically with a growing radius until an interior appears, and
    that interior is added to the original shell."""
    lo, hi = mesh.bounds
    origin = lo - pitch  # one voxel of margin so the flood wraps the mesh
    shape = tuple(int(np.ceil((h - o) / pitch)) + 2 for o, h in zip(origin, hi))
    surface = _rasterize_surface(mesh, origin, pitch, shape)
    filled = _flood_fill(surface)
    if int(filled.sum()) == int(surface.sum()) and min(shape) >= 6:
        for it in range(1, max_close_iters + 1):
            # pad so the dilation never walls off the border's exterior seed
            closed = ndimage.binary_closing(
                np.pad(surface, it + 1), iterations=it
            )[tuple([slice(it + 1, -(it + 1))] * 3)]
            filled_c = _flood_fill(closed)
            if int(filled_c.sum()) > int(closed.sum()):
                filled = surface | (filled_c & ~closed)
                break
    return filled, origin


def voxelize_points(mesh: TriMesh, pitch: float) -> np.ndarray:
    """(P, 3) float32 centers of the filled voxels: a body's particles at
    pitch = particle diameter."""
    filled, origin = voxelize_solid(mesh, pitch)
    idx = np.argwhere(filled)
    return (origin + (idx + 0.5) * pitch).astype(np.float32)
