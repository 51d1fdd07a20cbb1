// The pair code of the two sweep kernels, csrc/sweeps.cu (kernel A, the
// seg layout) and csrc/sweeps_linear.cu (kernel C, the linear layout):
// their grid and physics arguments, a row's cell decoded from its
// sort-time id, and the per-pair arithmetic of the TPU kernels' _tile_math
// (tisph_tpu/ops/pallas/sweeps.py:181-297): the cubic spline and the
// force coefficient of a fluid row.  Each kernel keeps only its own walk
// over the candidates and, in A, the rigid coupling's reaction terms.

#pragma once

#include <cuda_runtime.h>

namespace tisph {

struct GridArgs {
  int res0;   // cells along axis 0
  int res1;   // cells along axis 1 (3D only)
  int res_z;  // cells along the fastest axis
  int s0;     // id stride of axis 0
  int s1;     // id stride of axis 1 (3D only)
};

struct PhysArgs {
  float inv_h;     // 1 / h
  float fin;       // k_sig (density, bvol) or k_sig / h (gradient modes)
  float eps_visc;  // 0.01 h^2
  float visc_num;  // 2 nu h c_s
  float nub_num;   // sigma_b h c_s
  float coh_num;   // h * surface_tension
  float g[3];      // gravity
};

template <bool FAST>
__device__ __forceinline__ float fdiv(float a, float b) {
  return FAST ? a * __fdividef(1.0f, b) : a / b;
}

// Sort-time cell (cx, cy, cz) of an active row from its id; cy = 0 in 2D.
template <int DIM>
__device__ __forceinline__ void decode_cell(int id, const GridArgs& g, int& cx, int& cy,
                                            int& cz) {
  cx = id / g.s0;
  const int rem = id - cx * g.s0;
  cy = DIM == 3 ? rem / g.s1 : 0;
  cz = DIM == 3 ? rem - cy * g.s1 : rem;
}

// The spline of a pair at separation (dx, dy, dz), dz unused in 2D: r2,
// the value w and the gradient factor gmag, both before the k_sig
// finaliser.  False when q >= 1, where every term is exactly 0 (the
// branch-free spline clamps there), so the caller skips the pair.  The
// rsqrt clamp max(r2, 1e-12) keeps the self pair (dx bitwise 0) finite.
struct Spline {
  float r2, w, gmag;
};

template <int DIM>
__device__ __forceinline__ bool spline(float dx, float dy, float dz, float inv_h,
                                       Spline& s) {
  float r2 = dx * dx + dy * dy;
  if (DIM == 3) r2 += dz * dz;
  const float rs = rsqrtf(fmaxf(r2, 1e-12f));
  const float q = (r2 * rs) * inv_h;
  if (q >= 1.0f) return false;
  const float p1 = fmaxf(1.0f - q, 0.0f);
  const float p2 = fmaxf(0.5f - q, 0.0f);
  const float p1sq = p1 * p1;
  const float p2sq = p2 * p2;
  s.r2 = r2;
  s.w = 2.0f * p1 * p1sq - 8.0f * p2 * p2sq;
  s.gmag = (24.0f * p2sq - 6.0f * p1sq) * rs;
  return true;
}

// min(v_ij . x_ij, 0) / (r2 + 0.01 h^2), the viscosity's velocity term.
template <int DIM, bool FAST>
__device__ __forceinline__ float dot_neg(const float4& vi, const float4& vj, float dx,
                                         float dy, float dz, float r2, const PhysArgs& p) {
  float dot = (vi.x - vj.x) * dx + (vi.y - vj.y) * dy;
  if (DIM == 3) dot += (vi.z - vj.z) * dz;
  return fdiv<FAST>(fminf(dot, 0.0f), r2 + p.eps_visc);
}

// A fluid row i's own terms of the force mode, from its vel (w: rho_i) and
// aux (x: p_i / rho_i^2, z: m_i) packs.
struct FluidRow {
  float p_rho2;  // p_i / rho_i^2
  float coh;     // -h sigma_st / m_i
  float nub;     // sigma_b h c_s / (2 rho_i)
};

__device__ __forceinline__ FluidRow fluid_row(const float4& vi, const float4& ai,
                                              const PhysArgs& p) {
  return {ai.x, -(p.coh_num * (1.0f / fmaxf(ai.z, 1e-30f))), p.nub_num / (2.0f * vi.w)};
}

// The force coefficient of the pair (fluid i, j): viscosity against fluid
// and boundary j, pressure and cohesion; dv_i += coef * x_ij before the
// k_sig / h finaliser.  pj.w is effm_j, aj.y flm_j (m_j on fluid, 0 on
// boundary), aj.x p_j / rho_j^2.
template <bool FAST>
__device__ __forceinline__ float fluid_coef(const FluidRow& fi, const float4& vi,
                                            const float4& pj, const float4& vj,
                                            const float4& aj, float dneg, const Spline& s,
                                            const PhysArgs& p) {
  const float flm = aj.y;
  const float bdv = pj.w - flm;
  const float nu_f = p.visc_num * fdiv<FAST>(1.0f, vi.w + vj.w);
  const float visc = dneg * (flm * nu_f + bdv * fi.nub);
  const float press = pj.w * fi.p_rho2 + flm * aj.x;
  return (visc - press) * s.gmag + (fi.coh * flm) * s.w;
}

}  // namespace tisph
