"""Lattice sampler for fluid and boundary blocks (numpy only).

Per-axis ``np.arange(start, end, spacing)`` then an ij-meshgrid: the
reference's ``add_cube`` semantics, endpoint-exclusive.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def cube_lattice(
    start: Sequence[float],
    end: Sequence[float],
    spacing: float,
    translation: Sequence[float] | None = None,
    scale: Sequence[float] | None = None,
) -> np.ndarray:
    """(n, dim) f32 lattice of points in [start, end) with ``spacing``;
    ``scale`` and ``translation`` apply about the block origin."""
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    if scale is not None:
        end = start + (end - start) * np.asarray(scale, dtype=np.float64)
    axes = [np.arange(s, e, spacing) for s, e in zip(start, end)]
    grid = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grid], axis=-1).astype(np.float32)
    if translation is not None:
        pts = pts + np.asarray(translation, dtype=np.float32)
    return pts


def count_cube_particles(start: Sequence[float], end: Sequence[float], spacing: float) -> int:
    """Exact lattice count (reference compute_cube_particles_num,
    partice_systemv4.py:160-168)."""
    return int(np.prod([len(np.arange(s, e, spacing)) for s, e in zip(start, end)]))
