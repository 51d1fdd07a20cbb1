"""3D ball-pivoting surface reconstruction.

The reference delegates 3D BPA to Open3D
(render/bpa/d3.py:12-13: ``create_from_point_cloud_ball_pivoting`` with a
radius ladder); this module keeps that API shape, gated on open3d being
installed, and otherwise offers a marching-cubes fallback over the SPH
density field via scikit-image (also optional) or raises with guidance.
"""

from __future__ import annotations

import numpy as np


def reconstruct_ball_pivoting(points: np.ndarray, radii: list[float]):
    """Open3D ball-pivoting (reference d3.py path).  Returns an open3d
    TriangleMesh; raises ImportError when open3d is absent."""
    import open3d as o3d  # gated; not in the base image

    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(points, dtype=np.float64))
    pcd.estimate_normals()
    return o3d.geometry.TriangleMesh.create_from_point_cloud_ball_pivoting(
        pcd, o3d.utility.DoubleVector(list(radii))
    )


def reconstruct_marching_cubes(
    points: np.ndarray,
    particle_radius: float,
    grid_pitch: float | None = None,
    iso: float = 0.5,
):
    """Dependency-light 3D surface: splat points onto a density grid and run
    marching cubes (scikit-image).  Returns (vertices, faces)."""
    try:
        from skimage import measure
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "3D surface reconstruction needs open3d (ball pivoting) or "
            "scikit-image (marching cubes); neither is installed"
        ) from e

    pts = np.asarray(points, dtype=np.float64)
    pitch = grid_pitch or (2.0 * particle_radius)
    lo = pts.min(axis=0) - 2 * pitch
    hi = pts.max(axis=0) + 2 * pitch
    shape = np.maximum(((hi - lo) / pitch).astype(int) + 1, 2)
    grid = np.zeros(shape, dtype=np.float32)
    idx = ((pts - lo) / pitch).astype(int)
    np.add.at(grid, (idx[:, 0], idx[:, 1], idx[:, 2]), 1.0)
    # small separable blur so isolated particles still close a surface
    for axis in range(3):
        grid = (
            np.roll(grid, 1, axis) + 2 * grid + np.roll(grid, -1, axis)
        ) / 4.0
    verts, faces, _, _ = measure.marching_cubes(grid, level=iso)
    return verts * pitch + lo, faces
