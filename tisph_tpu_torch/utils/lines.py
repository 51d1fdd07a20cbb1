"""Domain wireframe helper (reference utils/lines.py: 8 corner points + 12
edge index pairs for the GGUI ``scene.lines`` overlay, main_3d.py:43)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

# edge list of the unit box (pairs of corner indices) — same topology the
# reference hardcodes at utils/lines.py:15
_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def domain_wireframe(
    domain_start: Sequence[float], domain_end: Sequence[float]
) -> tuple[np.ndarray, np.ndarray]:
    """(points (8,3), edges (12,2)) for a 3D box; (4,2)/(4,2) for 2D."""
    s = np.asarray(domain_start, dtype=np.float32)
    e = np.asarray(domain_end, dtype=np.float32)
    dim = len(s)
    if dim == 2:
        pts = np.array(
            [[s[0], s[1]], [e[0], s[1]], [s[0], e[1]], [e[0], e[1]]], np.float32
        )
        edges = np.array([(0, 1), (0, 2), (1, 3), (2, 3)], np.int32)
        return pts, edges
    corners = []
    for ix in (s[0], e[0]):
        for iy in (s[1], e[1]):
            for iz in (s[2], e[2]):
                corners.append([ix, iy, iz])
    # corner order: bit pattern (x, y, z); remap edges accordingly
    pts = np.asarray(corners, dtype=np.float32)
    edges = []
    for a in range(8):
        for b in range(a + 1, 8):
            if bin(a ^ b).count("1") == 1:  # neighbors differ in one axis
                edges.append((a, b))
    return pts, np.asarray(edges, dtype=np.int32)
