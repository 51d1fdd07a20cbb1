"""Disjoint-set union (union-find) and distance-based point clustering.

Counterpart of the reference's utils/dsu.py (path-compressed union-find,
:14-25, plus an O(n^2) all-pairs distance grouping, :29-52).  The all-pairs
pass does not scale to the 1M-particle BPA export target (SURVEY.md §7.3),
so clustering here is grid-accelerated: bin points into cells of size r and
union only within the 3^dim neighborhood — O(n * occupancy).  A C++ native
path (tisph_tpu_torch/native) accelerates the union loop at large n when built.
"""

from __future__ import annotations

import numpy as np


class DSU:
    """Array-based union-find with path halving + union by size."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]  # path halving
            i = p[i]
        return int(i)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]

    def groups(self) -> list[list[int]]:
        """Connected components as index lists (reference getAllGroups)."""
        roots = {}
        out: list[list[int]] = []
        for i in range(len(self.parent)):
            r = self.find(i)
            if r not in roots:
                roots[r] = len(out)
                out.append([])
            out[roots[r]].append(i)
        return out


def cluster_points(points: np.ndarray, radius: float, use_native: bool = True) -> list[list[int]]:
    """Group points whose pairwise distance < radius (transitively).

    Grid-accelerated: only pairs within the same or adjacent cells (cell
    size = radius) are tested — replaces the reference's O(n^2) loop
    (utils/dsu.py:29-36).
    """
    pts = np.asarray(points, dtype=np.float64)
    n, dim = pts.shape
    if n == 0:
        return []

    if use_native:
        try:
            from tisph_tpu_torch.native import loader

            lib = loader.load()
            if lib is not None:
                return loader.cluster_points(lib, pts, radius)
        except Exception:
            pass  # fall through to numpy path

    cell = np.floor(pts / radius).astype(np.int64)
    order = np.lexsort(cell.T[::-1])
    dsu = DSU(n)
    # map cell -> point indices
    from collections import defaultdict

    buckets: dict[tuple, list[int]] = defaultdict(list)
    for i in range(n):
        buckets[tuple(cell[i])].append(i)

    offsets = np.array(np.meshgrid(*([[-1, 0, 1]] * dim), indexing="ij")).reshape(dim, -1).T
    r2 = radius * radius
    for key, members in buckets.items():
        for off in offsets:
            nb = tuple(np.asarray(key) + off)
            if nb < key:  # visit each unordered cell pair once
                continue
            others = buckets.get(nb)
            if not others:
                continue
            for i in members:
                for j in others:
                    if i >= j and nb == key:
                        continue
                    d = pts[i] - pts[j]
                    if (d @ d) < r2:
                        dsu.union(i, j)
    return dsu.groups()
