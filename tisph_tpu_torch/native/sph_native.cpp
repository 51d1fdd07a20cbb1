// Native host-side kernels for tisph_tpu.
//
// The TPU compute path is JAX/XLA/Pallas; this C++ library covers the
// host-side post-processing that is sequential or pointer-chasing in
// nature and therefore a poor fit for the accelerator:
//
//  - cluster_points: grid-hashed union-find clustering (the reference's
//    utils/dsu.py does this O(n^2) in pure Python — unusable at the
//    1M-particle BPA export target, SURVEY.md §7.3)
//  - bpa_trace_2d:   2D ball-pivoting boundary walk (the reference's
//    render/bpa/d2.py frontier loop is inherently sequential per group,
//    SURVEY.md §3.4)
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct DSU {
  std::vector<int64_t> parent, size;
  explicit DSU(int64_t n) : parent(n), size(n, 1) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t i) {
    while (parent[i] != i) {
      parent[i] = parent[parent[i]];
      i = parent[i];
    }
    return i;
  }
  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
  }
};

struct CellKey {
  int64_t v[3];
  bool operator==(const CellKey& o) const {
    return v[0] == o.v[0] && v[1] == o.v[1] && v[2] == o.v[2];
  }
};

struct CellHash {
  size_t operator()(const CellKey& k) const {
    // large-prime spatial hash
    return static_cast<size_t>(k.v[0] * 73856093LL ^ k.v[1] * 19349663LL ^
                               k.v[2] * 83492791LL);
  }
};

}  // namespace

extern "C" {

// Grid-accelerated transitive clustering: points closer than `radius` end in
// the same component.  Writes a root label per point into `labels`.
// Returns the number of distinct components.
int64_t tisph_cluster_points(const double* pts, int64_t n, int32_t dim,
                             double radius, int64_t* labels) {
  if (n == 0) return 0;
  const double r2 = radius * radius;
  std::unordered_map<CellKey, std::vector<int64_t>, CellHash> grid;
  grid.reserve(static_cast<size_t>(n));
  auto cell_of = [&](int64_t i) {
    CellKey k{{0, 0, 0}};
    for (int32_t a = 0; a < dim; ++a)
      k.v[a] = static_cast<int64_t>(std::floor(pts[i * dim + a] / radius));
    return k;
  };
  for (int64_t i = 0; i < n; ++i) grid[cell_of(i)].push_back(i);

  DSU dsu(n);
  const int64_t lo = -1, hi = 1;
  for (const auto& kv : grid) {
    CellKey nb = kv.first;
    for (int64_t dx = lo; dx <= hi; ++dx)
      for (int64_t dy = (dim > 1 ? lo : 0); dy <= (dim > 1 ? hi : 0); ++dy)
        for (int64_t dz = (dim > 2 ? lo : 0); dz <= (dim > 2 ? hi : 0); ++dz) {
          nb.v[0] = kv.first.v[0] + dx;
          nb.v[1] = kv.first.v[1] + dy;
          nb.v[2] = kv.first.v[2] + dz;
          auto it = grid.find(nb);
          if (it == grid.end()) continue;
          for (int64_t i : kv.second)
            for (int64_t j : it->second) {
              if (j <= i) continue;
              double d2 = 0;
              for (int32_t a = 0; a < dim; ++a) {
                const double d = pts[i * dim + a] - pts[j * dim + a];
                d2 += d * d;
              }
              if (d2 < r2) dsu.unite(i, j);
            }
        }
  }
  int64_t ncomp = 0;
  std::unordered_map<int64_t, int64_t> remap;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = dsu.find(i);
    auto it = remap.find(r);
    if (it == remap.end()) {
      remap[r] = ncomp;
      labels[i] = ncomp++;
    } else {
      labels[i] = it->second;
    }
  }
  return ncomp;
}

// Surface prefilter for 2D point clouds: neighbor count per point via the
// same grid hash; caller thresholds the counts.  Used to cut million-point
// BPA inputs down to their surface shell before the pivot walk.
void tisph_neighbor_counts_2d(const double* pts, int64_t n, double radius,
                              int64_t* counts) {
  const double r2 = radius * radius;
  std::unordered_map<CellKey, std::vector<int64_t>, CellHash> grid;
  grid.reserve(static_cast<size_t>(n));
  auto cell_of = [&](int64_t i) {
    CellKey k{{0, 0, 0}};
    k.v[0] = static_cast<int64_t>(std::floor(pts[i * 2 + 0] / radius));
    k.v[1] = static_cast<int64_t>(std::floor(pts[i * 2 + 1] / radius));
    return k;
  };
  for (int64_t i = 0; i < n; ++i) grid[cell_of(i)].push_back(i);
  for (int64_t i = 0; i < n; ++i) counts[i] = 0;
  for (const auto& kv : grid) {
    CellKey nb = kv.first;
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy) {
        nb.v[0] = kv.first.v[0] + dx;
        nb.v[1] = kv.first.v[1] + dy;
        auto it = grid.find(nb);
        if (it == grid.end()) continue;
        for (int64_t i : kv.second)
          for (int64_t j : it->second) {
            if (j == i) continue;
            const double ax = pts[i * 2] - pts[j * 2];
            const double ay = pts[i * 2 + 1] - pts[j * 2 + 1];
            if (ax * ax + ay * ay < r2) ++counts[i];
          }
      }
  }
}

// 2D ball-pivoting boundary walk over one point group (reference geometry,
// render/bpa/d2.py:74-137): start from the highest point with the pivot
// circle directly above; repeatedly advance to the unvisited point with the
// minimum clockwise angle from the current pivot direction; update the
// pivot circle to sit on the new chord.  Writes the boundary vertex order
// into `order_out` (capacity n); returns the boundary length.
//
// `max_dist`: candidate search radius.  The reference scans ALL unvisited
// group members with no distance bound (a true ball pivot can only reach
// points within the circle's diameter), which degenerates into an O(n^2)
// tour on dense clouds; max_dist > 0 enables the proper bound via a grid
// hash (documented divergence; pass <= 0 for reference-exact behavior).
int64_t tisph_bpa_trace_2d(const double* pts, int64_t n,
                           const int64_t* members, int64_t n_members,
                           double radius, double max_dist,
                           int64_t* order_out) {
  if (n_members == 0) return 0;
  std::vector<uint8_t> visited(n, 0);

  std::unordered_map<CellKey, std::vector<int64_t>, CellHash> grid;
  const bool bounded = max_dist > 0;
  auto cell_of = [&](int64_t i) {
    CellKey k{{0, 0, 0}};
    k.v[0] = static_cast<int64_t>(std::floor(pts[i * 2 + 0] / max_dist));
    k.v[1] = static_cast<int64_t>(std::floor(pts[i * 2 + 1] / max_dist));
    return k;
  };
  if (bounded) {
    grid.reserve(static_cast<size_t>(n_members));
    for (int64_t k = 0; k < n_members; ++k) grid[cell_of(members[k])].push_back(members[k]);
  }

  // highest point of the group
  int64_t cur = members[0];
  for (int64_t k = 1; k < n_members; ++k) {
    int64_t i = members[k];
    if (pts[i * 2 + 1] > pts[cur * 2 + 1]) cur = i;
  }
  double cx = pts[cur * 2 + 0];
  double cy = pts[cur * 2 + 1] + radius;  // pivot circle starts above

  int64_t count = 0;
  order_out[count++] = cur;
  visited[cur] = 1;

  std::vector<int64_t> cand;
  while (true) {
    const double px = pts[cur * 2 + 0];
    const double py = pts[cur * 2 + 1];
    const double bx = cx - px, by = cy - py;  // base vector to pivot
    int64_t next = -1;
    double best = 361.0;

    cand.clear();
    if (bounded) {
      const double md2 = max_dist * max_dist;
      CellKey c0 = cell_of(cur);
      CellKey nb = c0;
      for (int64_t dx = -1; dx <= 1; ++dx)
        for (int64_t dy = -1; dy <= 1; ++dy) {
          nb.v[0] = c0.v[0] + dx;
          nb.v[1] = c0.v[1] + dy;
          auto it = grid.find(nb);
          if (it == grid.end()) continue;
          for (int64_t j : it->second) {
            if (visited[j]) continue;
            const double ax = pts[j * 2] - px, ay = pts[j * 2 + 1] - py;
            if (ax * ax + ay * ay <= md2) cand.push_back(j);
          }
        }
    } else {
      for (int64_t k = 0; k < n_members; ++k)
        if (!visited[members[k]]) cand.push_back(members[k]);
    }

    for (int64_t j : cand) {
      const double tx = pts[j * 2 + 0] - px;
      const double ty = pts[j * 2 + 1] - py;
      // clockwise angle from base to target in degrees (d2.py:57-71)
      const double dot = bx * tx + by * ty;
      const double cross = bx * ty - by * tx;
      double ang = -std::atan2(cross, dot) * 180.0 / M_PI;
      if (ang < 0) ang += 360.0;
      if (ang < best) {
        best = ang;
        next = j;
      }
    }
    if (next < 0) break;
    // new pivot circle sits on the chord cur->next (d2.py:95-112)
    const double ex = pts[next * 2 + 0], ey = pts[next * 2 + 1];
    const double mx = (px + ex) * 0.5, my = (py + ey) * 0.5;
    const double chord2 = (ex - px) * (ex - px) + (ey - py) * (ey - py);
    const double h2 = radius * radius - chord2 * 0.25;
    const double h = h2 > 0 ? std::sqrt(h2) : 0.0;
    // left normal of the chord direction (counter-clockwise boundary)
    double dx = ex - px, dy = ey - py;
    const double len = std::sqrt(chord2);
    if (len > 0) {
      dx /= len;
      dy /= len;
    }
    cx = mx - dy * h;
    cy = my + dx * h;
    visited[next] = 1;
    order_out[count++] = next;
    cur = next;
  }
  return count;
}

}  // extern "C"
