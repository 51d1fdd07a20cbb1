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
// Design: one thread per row i of the cell-sorted state, as the reference
// Taichi code walks for_all_neighbors.  The thread decodes i's sort-time
// cell from its sort-time id, and for each of the 3^(dim-1) stencil rows
// inside the grid reads the contiguous candidate range
// [bounds[c_lo], bounds[c_hi + 1]) and sums over it in f32 registers.
// Rows outside the mode's consumer family (fluid for density and force,
// boundary for bvol and reaction, fluid or boundary for force_react)
// write 0 and exit at once.  No shared-memory tiling, TMA or tensor cores:
// the sweep is bound by the j loads (about 27 * 64 = 1,728 candidates per
// interior i at radius spacing, about 270 of them inside h), which mostly
// hit L2; neighbouring threads sit in the same or adjacent cells and walk
// nearly the same runs, so their loads partly coalesce into broadcasts.
// Pairs with q >= 1 are skipped before the gradient modes' j loads of
// velocity and pressure: the branch-free spline is exactly 0 there, so
// the skip changes no sum.
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

template <int MODE, int DIM, bool FAST>
__global__ void __launch_bounds__(128)
sweep_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
             const float4* __restrict__ aux, const int* __restrict__ ids,
             const int* __restrict__ bounds, const int* __restrict__ material,
             float* __restrict__ out, int n, GridArgs g, PhysArgs p) {
  constexpr bool kGrad = MODE == kForce || MODE == kForceReact || MODE == kReaction;
  constexpr int kOut = kGrad ? DIM : 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int mat = material[i];
  const bool consumer = (MODE == kBvol || MODE == kReaction) ? (mat == 0)
                        : (MODE == kForceReact)               ? (mat == 0 || mat == 1)
                                                              : (mat == 1);
  if (!consumer) {
#pragma unroll
    for (int a = 0; a < kOut; ++a) out[i * kOut + a] = 0.0f;
    return;
  }
  // reaction arithmetic on this row: every row of the reaction mode, the
  // boundary rows of force_react
  const bool react_i = MODE == kReaction || (MODE == kForceReact && mat == 0);

  // sort-time cell of i, decoded from its id
  int cx, cy, cz;
  decode_cell<DIM>(ids[i], g, cx, cy, cz);
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g.res_z - 1);

  const float4 pi = pos[i];
  float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
  FluidRow fi{0.f, 0.f, 0.f};
  if (kGrad) vi = vel[i];
  if (kGrad && !react_i) fi = fluid_row(vi, aux[i], p);
  const float bvol_i = pi.w;            // rho0 V_i on a boundary row
  const float nub_half = 0.5f * p.nub_num;  // sigma_b h c_s / 2, exact
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;

  constexpr int kOy = (DIM == 3) ? 1 : 0;
  for (int ox = -1; ox <= 1; ++ox) {
    const int nx = cx + ox;
    if (nx < 0 || nx >= g.res0) continue;
    for (int oy = -kOy; oy <= kOy; ++oy) {
      const int ny = cy + oy;
      if (DIM == 3 && (ny < 0 || ny >= g.res1)) continue;
      const int base = nx * g.s0 + ny * g.s1;  // ny == 0 in 2D
      const int j1 = bounds[base + zhi + 1];
      for (int j = bounds[base + zlo]; j < j1; ++j) {
        const float4 pj = pos[j];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        Spline s;
        if (!spline<DIM>(dx, dy, dz, p.inv_h, s)) continue;
        if (!kGrad) {
          acc0 += pj.w * s.w;
          continue;
        }
        const float4 vj = vel[j];
        const float4 aj = aux[j];
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
      }
    }
  }

  if (kGrad && react_i) {  // a force on a body particle: no gravity here
    out[i * DIM + 0] = acc0 * p.fin;
    out[i * DIM + 1] = acc1 * p.fin;
    if (DIM == 3) out[i * DIM + 2] = acc2 * p.fin;
  } else if (kGrad) {
    out[i * DIM + 0] = acc0 * p.fin + p.g[0];
    out[i * DIM + 1] = acc1 * p.fin + p.g[1];
    if (DIM == 3) out[i * DIM + 2] = acc2 * p.fin + p.g[2];
  } else {
    out[i] = acc0 * p.fin;
  }
}

template <int MODE, int DIM, bool FAST>
void launch(const void* pos, const void* vel, const void* aux, const void* ids,
            const void* bounds, const void* material, void* out, int n,
            const GridArgs& g, const PhysArgs& p, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  sweep_kernel<MODE, DIM, FAST><<<blocks, threads, 0, stream>>>(
      static_cast<const float4*>(pos), static_cast<const float4*>(vel),
      static_cast<const float4*>(aux), static_cast<const int*>(ids),
      static_cast<const int*>(bounds), static_cast<const int*>(material),
      static_cast<float*>(out), n, g, p);
}

template <int MODE, int DIM>
void launch_fast(int fast, const void* pos, const void* vel, const void* aux,
                 const void* ids, const void* bounds, const void* material,
                 void* out, int n, const GridArgs& g, const PhysArgs& p,
                 cudaStream_t stream) {
  if (fast) {
    launch<MODE, DIM, true>(pos, vel, aux, ids, bounds, material, out, n, g, p, stream);
  } else {
    launch<MODE, DIM, false>(pos, vel, aux, ids, bounds, material, out, n, g, p, stream);
  }
}

}  // namespace

// mode: 0 density, 1 force, 2 bvol, 3 force_react, 4 reaction; dim: 2 or
// 3; fast_math is read by the three gradient modes.  vel and aux are read
// by the gradient modes only.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unknown mode or dim.
extern "C" int tisph_sweep(int mode, int dim, int fast_math, const void* pos,
                           const void* vel, const void* aux, const void* ids,
                           const void* bounds, const void* material, void* out,
                           int n, int res0, int res1, int res_z, int s0, int s1,
                           float inv_h, float fin, float eps_visc,
                           float visc_num, float nub_num, float coh_num,
                           float gx, float gy, float gz, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const GridArgs g{res0, res1, res_z, s0, s1};
  const PhysArgs p{inv_h, fin, eps_visc, visc_num, nub_num, coh_num, {gx, gy, gz}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TISPH_ARGS pos, vel, aux, ids, bounds, material, out, n, g, p, st
  if (dim == 3 && mode == kDensity) {
    launch<kDensity, 3, false>(TISPH_ARGS);
  } else if (dim == 3 && mode == kBvol) {
    launch<kBvol, 3, false>(TISPH_ARGS);
  } else if (dim == 3 && mode == kForce) {
    launch_fast<kForce, 3>(fast_math, TISPH_ARGS);
  } else if (dim == 3 && mode == kForceReact) {
    launch_fast<kForceReact, 3>(fast_math, TISPH_ARGS);
  } else if (dim == 3 && mode == kReaction) {
    launch_fast<kReaction, 3>(fast_math, TISPH_ARGS);
  } else if (dim == 2 && mode == kDensity) {
    launch<kDensity, 2, false>(TISPH_ARGS);
  } else if (dim == 2 && mode == kBvol) {
    launch<kBvol, 2, false>(TISPH_ARGS);
  } else if (dim == 2 && mode == kForce) {
    launch_fast<kForce, 2>(fast_math, TISPH_ARGS);
  } else if (dim == 2 && mode == kForceReact) {
    launch_fast<kForceReact, 2>(fast_math, TISPH_ARGS);
  } else if (dim == 2 && mode == kReaction) {
    launch_fast<kReaction, 2>(fast_math, TISPH_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TISPH_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tisph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
