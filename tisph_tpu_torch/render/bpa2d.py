"""2D ball-pivoting boundary extraction (surface reconstruction).

Counterpart of the reference's render/bpa/d2.py: cluster the point set with
union-find (DSU pre-grouping, d2.py:20-34), then per group walk the boundary
with a pivoting circle — start at the highest point with the circle directly
above, repeatedly advance to the unvisited point with the minimum clockwise
angle, updating the circle to sit on each new chord (d2.py:74-137).

The walk is inherently sequential per group, so it stays on the host
(SURVEY.md §3.4): the hot parts (grid-hashed clustering + the O(k n) walk)
run in the C++ native library when available, with a numpy fallback.
Output is boundary polylines + an optional triangle-fan fill, matching the
reference's ``gui.triangles`` rendering (d2.py:165-176).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tisph_tpu_torch.utils.dsu import cluster_points


@dataclasses.dataclass
class Boundary2D:
    points: np.ndarray            # (n, 2) input points
    loops: list[np.ndarray]       # per group: boundary vertex indices, in walk order
    edges: np.ndarray             # (m, 2) concatenated boundary edges

    def triangle_fans(self) -> list[np.ndarray]:
        """Per loop: (k-2, 3) triangle-fan indices for filled rendering."""
        fans = []
        for loop in self.loops:
            if len(loop) < 3:
                continue
            base = loop[0]
            fans.append(
                np.stack(
                    [np.full(len(loop) - 2, base), loop[1:-1], loop[2:]], axis=1
                )
            )
        return fans


def _trace_group_numpy(
    pts: np.ndarray, members: np.ndarray, radius: float, max_dist: float = 0.0
) -> np.ndarray:
    """Pure-numpy ball-pivot walk (reference d2.py:74-137 semantics;
    ``max_dist`` > 0 bounds the candidate reach like the native walk)."""
    visited = np.zeros(pts.shape[0], dtype=bool)
    cur = members[np.argmax(pts[members, 1])]
    circle = pts[cur] + np.array([0.0, radius])
    order = [int(cur)]
    visited[cur] = True
    while True:
        p = pts[cur]
        base = circle - p
        cand = members[~visited[members]]
        if max_dist > 0 and cand.size:
            d2 = ((pts[cand] - p) ** 2).sum(axis=1)
            cand = cand[d2 <= max_dist * max_dist]
        if cand.size == 0:
            break
        t = pts[cand] - p
        dot = base[0] * t[:, 0] + base[1] * t[:, 1]
        cross = base[0] * t[:, 1] - base[1] * t[:, 0]
        ang = -np.degrees(np.arctan2(cross, dot))
        ang = np.where(ang < 0, ang + 360.0, ang)
        nxt = int(cand[np.argmin(ang)])
        e = pts[nxt]
        mid = (p + e) / 2.0
        chord2 = float(((e - p) ** 2).sum())
        h = np.sqrt(max(radius * radius - chord2 / 4.0, 0.0))
        d = e - p
        ln = np.sqrt(chord2)
        if ln > 0:
            d = d / ln
        circle = np.array([mid[0] - d[1] * h, mid[1] + d[0] * h])
        visited[nxt] = True
        order.append(nxt)
        cur = nxt
    return np.asarray(order, dtype=np.int64)


def surface_prefilter(
    pts: np.ndarray, radius: float, rel_threshold: float = 0.8,
    use_native: bool = True,
) -> np.ndarray:
    """Indices of likely-surface points: neighbor count below
    ``rel_threshold`` x the 90th-percentile count (interior points of a
    dense set have full neighborhoods; surface points roughly half).
    Grid-binned O(n * occupancy); makes million-point BPA feasible (the
    pivot walk is O(boundary * candidates)).  Counts run in the C++ native
    library when available."""
    n = pts.shape[0]
    counts = None
    if use_native:
        try:
            from tisph_tpu_torch.native import loader

            lib = loader.load()
            if lib is not None:
                counts = loader.neighbor_counts_2d(lib, pts, radius)
        except Exception:
            counts = None
    if counts is None:
        cell = np.floor(pts / radius).astype(np.int64)
        from collections import defaultdict

        tmp = defaultdict(list)
        for i, c in enumerate(map(tuple, cell)):
            tmp[c].append(i)
        buckets = {k: np.asarray(v) for k, v in tmp.items()}
        r2 = radius * radius
        counts = np.zeros(n, dtype=np.int64)
        offs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
                (1, -1), (1, 0), (1, 1)]
        for key, members in buckets.items():
            cand = [buckets[k2] for k2 in ((key[0] + o[0], key[1] + o[1]) for o in offs) if k2 in buckets]
            cand = np.concatenate(cand)
            d2 = ((pts[members][:, None, :] - pts[cand][None, :, :]) ** 2).sum(-1)
            counts[members] = (d2 < r2).sum(axis=1) - 1  # minus self
    full = np.percentile(counts, 90)
    return np.flatnonzero(counts < rel_threshold * max(full, 1.0))


def extract_boundary_2d(
    points: np.ndarray,
    radius: float,
    use_native: bool = True,
    prefilter_above: int = 50_000,
    bounded_walk_above: int = 5_000,
) -> Boundary2D:
    """Cluster + per-group ball-pivot boundary walk.

    Above ``prefilter_above`` points, interior points are removed first via
    :func:`surface_prefilter` (the walk only ever visits surface points);
    the returned indices still refer to the ORIGINAL point array.

    Above ``bounded_walk_above`` points the walk restricts candidates to
    the true ball-pivot reach (2 x radius, grid-hashed).  The reference
    scans every unvisited point with no distance bound
    (render/bpa/d2.py:74-93) — O(n^2) and degenerate on dense clouds;
    below the threshold we keep that reference-exact behavior.
    """
    pts_all = np.asarray(points, dtype=np.float64)
    sel = None
    if prefilter_above and pts_all.shape[0] > prefilter_above:
        # 3D-projected clouds stack many z-layers onto each xy point —
        # dedupe to one representative per (radius/3) grid cell first, or
        # the per-bucket pairwise counts blow up quadratically.
        key = np.round(pts_all / (radius / 3.0)).astype(np.int64)
        _, uniq_idx = np.unique(key, axis=0, return_index=True)
        sel = np.sort(uniq_idx)
        if sel.shape[0] > prefilter_above:
            sub = surface_prefilter(pts_all[sel], radius)
            sel = sel[sub]
        pts = pts_all[sel]
    else:
        pts = pts_all
    groups = cluster_points(pts, radius, use_native=use_native)

    lib = None
    if use_native:
        try:
            from tisph_tpu_torch.native import loader

            lib = loader.load()
        except Exception:
            lib = None

    loops: list[np.ndarray] = []
    edge_list = []
    for g in groups:
        members = np.asarray(g, dtype=np.int64)
        if members.size == 1:
            loops.append(members)
            continue
        max_dist = 2.0 * radius if pts.shape[0] > bounded_walk_above else 0.0
        if lib is not None:
            from tisph_tpu_torch.native import loader

            order = loader.bpa_trace_2d(lib, pts, members, radius, max_dist)
        else:
            order = _trace_group_numpy(pts, members, radius, max_dist)
        loops.append(order)
        if len(order) >= 2:
            edge_list.append(np.stack([order[:-1], order[1:]], axis=1))
    edges = (
        np.concatenate(edge_list, axis=0)
        if edge_list
        else np.zeros((0, 2), dtype=np.int64)
    )
    if sel is not None:  # remap filtered indices back to the original array
        loops = [sel[l] for l in loops]
        edges = sel[edges] if edges.size else edges
        pts = pts_all
    return Boundary2D(points=pts, loops=loops, edges=edges)
