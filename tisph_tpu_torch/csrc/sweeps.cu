// WCSPH neighbour sweeps (density, force, bvol, force_react, reaction) for
// Hopper (sm_90a).
//
// Replaces tisph_tpu/ops/pallas/sweeps.py::_seg_sweep_kernel, the TPU's
// seg-layout sweep, in all five of its physics modes; the pair math is
// that kernel's _tile_math (sweeps.py:181-297) and _ivals_acc0
// (sweeps.py:307-381), mirrored by the plain versions in
// tisph_tpu_torch/ops/neighbors.py.  The pair code it shares with the
// linear-layout kernel C (csrc/sweeps_linear.cu) is in sweep_common.cuh.
//
// Design.  A row i of the cell-sorted state decodes its sort-time cell
// from its sort-time id, and for each of the 3^(dim-1) stencil rows inside
// the grid walks the contiguous candidate range
// [bounds[c_lo], bounds[c_hi + 1]) and sums over it in f32 registers, as
// the reference Taichi code walks for_all_neighbors.  The swept rows are
// all rows, a range [row0, row0 + n) of them (a slab shard's rows of its
// halo window), or an i-row map: n positions in the arrays (a rectangle
// shard's own rows, which the id merge interleaves with its halo rows; the
// TPU kernel takes them as a separate i pack, sweeps.py:1166-1182).  Rows
// outside the
// mode's consumer family (fluid for density and force, boundary for bvol
// and reaction, fluid or boundary for force_react) walk nothing and write
// 0.  No tensor cores (r^2 must come from f32 differences) and no TMA (the
// runs have unaligned starts and data-dependent lengths).
//
// What bounds it on this card is neither the device-memory bytes (every j
// is read again from L1 or L2 by each row near it) nor the f32 operations
// of the pairs inside h, but the candidate test: at radius spacing a row
// walks 165 (thinned fluid) to 1,728 (start lattice) candidates and four
// or five of six lie outside h.  Measured on an NVIDIA H100 80GB HBM3 at
// a 700.00 W power limit, in this order:
// - the test's instructions: q = r / h through rsqrtf is a multi-cycle
//   MUFU operation per candidate, so a candidate is first dropped on r^2
//   alone (r^2 > 1.0001 h^2, wider than any rounding of q); spline()
//   still makes the exact q < 1 test on what is left, so the pairs summed
//   are the same ones (0.78-0.89 of the time without it in density);
// - the L1 wavefronts of the j loads (read out of the timings: no
//   profiler counter can be read on that machine): with one thread per row
//   the 32 lanes of a warp read up to 32 different 16-byte rows per load,
//   and where the fluid has thinned (about 6 particles to a cell) they
//   do.  With L lanes per row (a template constant, picked by the wrapper
//   from the row count alone), lane l of a row takes candidates j0 + l,
//   j0 + l + L, ... of every run, so a row's lanes read 16 L consecutive
//   bytes per trip, and the card gets L times the threads, which is what a
//   launch of 60k rows (475 CTAs of one thread per row on 132 SMs) lacks
//   most: latency.  The lanes' partial sums are added by xor shuffles in
//   a fixed order and written by lane 0: deterministic, no atomics.  4
//   lanes (8 in bvol and reaction, whose consumer rows are few) take 0.3
//   to 0.8 of one lane's time at 60,864 and 195,304 rows; towards
//   1,000,000 rows the rows alone fill the SMs and lanes lose, so large
//   launches keep one thread per row (the rule, by mode and row count, is
//   ops/cuda/sweeps.py's);
// - divergence in the gradient modes: after the test about a fifth of a
//   warp's lanes hold a pair, and the pair stage (the vel[j] and aux[j]
//   loads, about 40 operations) would run for that fifth.  With L > 1
//   the walk has two stages.  Test stage: four candidates per trip, their
//   pos loads in flight together, and each j that passes r^2 is appended
//   to the thread's queue in shared memory (16 slots, laid out
//   [slot][thread], so a warp's accesses fall on 32 banks; 8 KB a CTA).
//   Pair stage: when a warp vote says some lane's queue could overflow in
//   the next trip, and once after the last run, every lane drains its
//   queue in order through the pair arithmetic.  Each thread adds its own
//   pairs in j order, stencil row by stencil row.  Rows off the family,
//   the inactive tail and the ragged last block stay in the loop with
//   empty runs, so every vote and shuffle sees all 32 lanes.  With one
//   thread per row the queue lost to the direct walk at 195k and 1,000,000
//   rows (1.05-1.19 of its time: a lane's queued j are its own, so the
//   drain's loads no longer share addresses across the lanes of a cell,
//   which on a dense lattice they all do), so L = 1 keeps the direct
//   walk: test, and on a hit the pair at once.
// At one lane per row the sums are one thread's in j order, the order of
// the linear-layout kernel C, whose density is bitwise equal.
//
// The rigid coupling modes (two-way Akinci coupling):
// - reaction: boundary i accumulates the fluid -> boundary force
//   F_i = (k_sig / h) bvol_i sum_j flm_j (nu_b,j dot_neg - p_j / rho_j^2)
//   grad W_ij, with nu_b,j = sigma_b h c_s / (2 rho_j) and bvol_i = rho0 V_i,
//   read from pos.w (effm, which is rho0 V on boundary rows);
// - force_react: the force mode on fluid rows and the reaction on boundary
//   rows in one pass; boundary rows get neither gravity nor cohesion.  Each
//   side's per-pair arithmetic is the one of its separate mode, so the
//   fused output equals force and reaction on their rows.
//
// Numerics kept from the TPU kernel:
// - self pair: density and bvol fold W(0) in through j == i; in the
//   gradient modes dx is bitwise 0 (x_i and x_j come from the same buffer)
//   and the rsqrt clamp max(r2, 1e-12) keeps coef finite, so it adds
//   exactly 0 (and flm_i = 0 for a boundary i);
// - the spline normalisation k_sig (k_sig / h for the gradient modes) is
//   one multiply per i after the sum, and the cohesion coefficient carries
//   the extra h;
// - gravity is added once per fluid i after the sum;
// - FAST = fast_math: an approximate reciprocal (__fdividef) on the
//   viscosity-only divides (and the reaction's 1 / rho_j); otherwise exact
//   IEEE divides.

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using namespace tisph;

enum Mode { kDensity = 0, kForce = 1, kBvol = 2, kForceReact = 3, kReaction = 4 };

constexpr int kThreads = 128;  // threads per CTA, whatever the lanes per row
constexpr unsigned kFull = 0xffffffffu;
// the two-stage walk of the gradient modes: queue slots per thread, and
// candidates tested per trip of the test stage
constexpr int kQueue = 16;
constexpr int kBatch = 4;
static_assert(kBatch <= kQueue, "a trip's candidates must fit an empty queue");

// resident CTAs per SM the compiler must leave registers for (the second
// launch bound): with 8, density and bvol take 37 registers where the
// default squeezes them into 32 (3-5% slower at 195k rows); the gradient
// modes, at 56 to 72 registers, lost with any bound and are left free
template <int MODE>
constexpr int kMinCtasOf = (MODE == kDensity || MODE == kBvol) ? 8 : 1;

template <int MODE, int DIM, bool FAST, int L>
__global__ void __launch_bounds__(kThreads, kMinCtasOf<MODE>)
sweep_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
             const float4* __restrict__ aux, const int* __restrict__ ids,
             const int* __restrict__ bounds, const int* __restrict__ material,
             const int* __restrict__ irows, float* __restrict__ out, int row0, int rows,
             int n_all, GridArgs g, PhysArgs p) {
  constexpr bool kGrad = MODE == kForce || MODE == kForceReact || MODE == kReaction;
  constexpr int kOut = kGrad ? DIM : 1;
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lanes per row: a power of two");
  const int tid = threadIdx.x;
  const int sub = tid % L;  // this thread's lane of its row
  // output row t sweeps row i of the arrays: irows[t] with an i-row map,
  // else row0 + t; out holds the swept rows only, in t order
  const int t = blockIdx.x * (kThreads / L) + tid / L;
  const bool in_n = t < rows;
  const int i = !in_n ? 0 : irows != nullptr ? irows[t] : row0 + t;
  // a map entry outside the arrays sweeps nothing (the wrapper cannot
  // read the map without waiting for the device)
  const int mat = in_n && i >= 0 && i < n_all ? material[i] : -1;
  const bool consumer = (MODE == kBvol || MODE == kReaction) ? (mat == 0)
                        : (MODE == kForceReact)               ? (mat == 0 || mat == 1)
                                                              : (mat == 1);
  // reaction arithmetic on this row: every row of the reaction mode, the
  // boundary rows of force_react
  const bool react_i = MODE == kReaction || (MODE == kForceReact && mat == 0);

  // sort-time cell of i, decoded from its id; a row outside the family
  // stays in the walk with empty runs, so the warp's votes and shuffles
  // below see all 32 lanes
  int cx = 0, cy = 0, cz = 0;
  if (consumer) decode_cell<DIM>(ids[i], g, cx, cy, cz);
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g.res_z - 1);

  float4 pi = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
  FluidRow fi{0.f, 0.f, 0.f};
  if (consumer) pi = pos[i];
  if (kGrad && consumer) vi = vel[i];
  if (kGrad && consumer && !react_i) fi = fluid_row(vi, aux[i], p);
  const float bvol_i = pi.w;                // rho0 V_i on a boundary row
  const float nub_half = 0.5f * p.nub_num;  // sigma_b h c_s / 2, exact
  // a candidate beyond this r^2 has q >= 1 whatever the rounding of q
  const float r2_cut = 1.0001f / (p.inv_h * p.inv_h);
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;

  // adds the pair (i, j) of a gradient mode, x_ij = (dx, dy, dz) inside h
  auto add_pair = [&](const float4& pj, const float4& vj, const float4& aj, float dx, float dy,
                      float dz, const Spline& s) {
    const float dneg = dot_neg<DIM, FAST>(vi, vj, dx, dy, dz, s.r2, p);
    float coef;
    if (react_i) {
      const float nub_j = nub_half * fdiv<FAST>(1.0f, fmaxf(vj.w, 1e-12f));
      coef = (bvol_i * (aj.y * (nub_j * dneg - aj.x))) * s.gmag;
    } else {
      coef = fluid_coef<FAST>(fi, vi, pj, vj, aj, dneg, s, p);
    }
    acc0 += coef * dx;
    acc1 += coef * dy;
    if (DIM == 3) acc2 += coef * dz;
  };

  constexpr int kOy = (DIM == 3) ? 1 : 0;
  if constexpr (!kGrad || L == 1) {
    // the direct walk: test, and on a hit the pair at once
    for (int ox = -1; ox <= 1; ++ox) {
      const int nx = cx + ox;
      if (!consumer || nx < 0 || nx >= g.res0) continue;
      for (int oy = -kOy; oy <= kOy; ++oy) {
        const int ny = cy + oy;
        if (DIM == 3 && (ny < 0 || ny >= g.res1)) continue;
        const int base = nx * g.s0 + ny * g.s1;  // ny == 0 in 2D
        const int j1 = bounds[base + zhi + 1];
        for (int j = bounds[base + zlo] + sub; j < j1; j += L) {
          const float4 pj = pos[j];
          const float dx = pi.x - pj.x;
          const float dy = pi.y - pj.y;
          const float dz = pi.z - pj.z;
          float r2 = dx * dx + dy * dy;
          if (DIM == 3) r2 += dz * dz;
          if (r2 > r2_cut) continue;
          Spline s;
          if (!spline<DIM>(dx, dy, dz, p.inv_h, s)) continue;
          if constexpr (kGrad) {
            add_pair(pj, vel[j], aux[j], dx, dy, dz, s);
          } else {
            acc0 += pj.w * s.w;
          }
        }
      }
    }
  } else {
    // the two-stage walk: queue the j that pass r^2, drain on a warp vote
    __shared__ int queue[kQueue * kThreads];  // [slot][thread]
    int qn = 0;
    auto drain = [&]() {
#pragma unroll 1
      for (int slot = 0; slot < qn; ++slot) {
        const int j = queue[slot * kThreads + tid];
        const float4 pj = pos[j];  // nearly every entry is inside h: all
        const float4 vj = vel[j];  // three loads go out together
        const float4 aj = aux[j];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        Spline s;
        if (spline<DIM>(dx, dy, dz, p.inv_h, s)) add_pair(pj, vj, aj, dx, dy, dz, s);
      }
      qn = 0;
    };
    constexpr int kStep = L * kBatch;
    for (int ox = -1; ox <= 1; ++ox) {
      const int nx = cx + ox;
      for (int oy = -kOy; oy <= kOy; ++oy) {
        const int ny = cy + oy;
        int j = 0, j1 = 0;  // an empty run off the grid or off the family
        if (consumer && nx >= 0 && nx < g.res0 && (DIM == 2 || (ny >= 0 && ny < g.res1))) {
          const int base = nx * g.s0 + ny * g.s1;  // ny == 0 in 2D
          j = bounds[base + zlo] + sub;
          j1 = bounds[base + zhi + 1];
        }
        const int trips = j < j1 ? (j1 - j + kStep - 1) / kStep : 0;
        const int warp_trips = __reduce_max_sync(kFull, trips);
        for (int t = 0; t < warp_trips; ++t, j += kStep) {
          float4 pj[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (j + u * L < j1) pj[u] = pos[j + u * L];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (j + u * L < j1) {
              const float dx = pi.x - pj[u].x;
              const float dy = pi.y - pj[u].y;
              const float dz = pi.z - pj[u].z;
              float r2 = dx * dx + dy * dy;
              if (DIM == 3) r2 += dz * dz;
              if (r2 <= r2_cut) {
                queue[qn * kThreads + tid] = j + u * L;
                ++qn;
              }
            }
          }
          if (__any_sync(kFull, qn > kQueue - kBatch)) drain();
        }
      }
    }
    drain();
  }

  // a row's lanes add their partial sums in a fixed order
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    acc0 += __shfl_xor_sync(kFull, acc0, o);
    if (kGrad) acc1 += __shfl_xor_sync(kFull, acc1, o);
    if (kGrad && DIM == 3) acc2 += __shfl_xor_sync(kFull, acc2, o);
  }
  if (!in_n || sub != 0) return;
  float* o = out + t * kOut;
  if (!consumer) {
#pragma unroll
    for (int a = 0; a < kOut; ++a) o[a] = 0.0f;
  } else if (kGrad && react_i) {  // a force on a body particle: no gravity here
    o[0] = acc0 * p.fin;
    o[1] = acc1 * p.fin;
    if (DIM == 3) o[2] = acc2 * p.fin;
  } else if (kGrad) {
    o[0] = acc0 * p.fin + p.g[0];
    o[1] = acc1 * p.fin + p.g[1];
    if (DIM == 3) o[2] = acc2 * p.fin + p.g[2];
  } else {
    o[0] = acc0 * p.fin;
  }
}

// One call's arguments, as the kernel takes them.
struct Call {
  const float4 *pos, *vel, *aux;
  const int *ids, *bounds, *material, *irows;
  float* out;
  int row0, rows, n_all;
  GridArgs g;
  PhysArgs p;
  cudaStream_t stream;
};

template <int MODE, int DIM, bool FAST, int L>
void launch(const Call& c) {
  constexpr int per_cta = kThreads / L;
  const int blocks = (c.rows + per_cta - 1) / per_cta;
  sweep_kernel<MODE, DIM, FAST, L><<<blocks, kThreads, 0, c.stream>>>(
      c.pos, c.vel, c.aux, c.ids, c.bounds, c.material, c.irows, c.out, c.row0, c.rows,
      c.n_all, c.g, c.p);
}

// False for a lane count that is not built: 1, 4 and 8 are.
template <int MODE, int DIM, bool FAST>
bool launch_lanes(int lanes, const Call& c) {
  switch (lanes) {
    case 1: launch<MODE, DIM, FAST, 1>(c); return true;
    case 4: launch<MODE, DIM, FAST, 4>(c); return true;
    case 8: launch<MODE, DIM, FAST, 8>(c); return true;
    default: return false;
  }
}

template <int MODE, int DIM>
bool launch_fast(int fast, int lanes, const Call& c) {
  constexpr bool kGrad = MODE == kForce || MODE == kForceReact || MODE == kReaction;
  if (kGrad && fast) return launch_lanes<MODE, DIM, kGrad>(lanes, c);
  return launch_lanes<MODE, DIM, false>(lanes, c);
}

template <int DIM>
bool launch_mode(int mode, int fast, int lanes, const Call& c) {
  switch (mode) {
    case kDensity: return launch_fast<kDensity, DIM>(fast, lanes, c);
    case kForce: return launch_fast<kForce, DIM>(fast, lanes, c);
    case kBvol: return launch_fast<kBvol, DIM>(fast, lanes, c);
    case kForceReact: return launch_fast<kForceReact, DIM>(fast, lanes, c);
    case kReaction: return launch_fast<kReaction, DIM>(fast, lanes, c);
    default: return false;
  }
}

}  // namespace

// mode: 0 density, 1 force, 2 bvol, 3 force_react, 4 reaction; dim: 2 or
// 3; fast_math is read by the three gradient modes; lanes: threads per
// row, 1, 4 or 8.  vel and aux are read by the gradient modes only.  The
// arrays hold n_all rows.  The launch sweeps `rows` rows of them (their
// candidates anywhere in them) and writes out[0, rows): row t of out is
// row irows[t] with an i-row map (irows not null, rows int32 entries), else
// row row0 + t.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an unknown mode, dim or lanes.
extern "C" int tisph_sweep(int mode, int dim, int fast_math, int lanes, const void* pos,
                           const void* vel, const void* aux, const void* ids,
                           const void* bounds, const void* material, const void* irows,
                           void* out, int row0, int rows, int n_all, int res0, int res1,
                           int res_z, int s0, int s1,
                           float inv_h, float fin, float eps_visc,
                           float visc_num, float nub_num, float coh_num,
                           float gx, float gy, float gz, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const Call c{static_cast<const float4*>(pos),  static_cast<const float4*>(vel),
               static_cast<const float4*>(aux),  static_cast<const int*>(ids),
               static_cast<const int*>(bounds),  static_cast<const int*>(material),
               static_cast<const int*>(irows),   static_cast<float*>(out),
               row0, rows, n_all,
               GridArgs{res0, res1, res_z, s0, s1},
               PhysArgs{inv_h, fin, eps_visc, visc_num, nub_num, coh_num, {gx, gy, gz}},
               static_cast<cudaStream_t>(stream)};
  const bool known = dim == 3   ? launch_mode<3>(mode, fast_math, lanes, c)
                     : dim == 2 ? launch_mode<2>(mode, fast_math, lanes, c)
                                : false;
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tisph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
