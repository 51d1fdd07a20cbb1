// The legacy (V1) solver's two pair sums, density and force, for Hopper
// (sm_90a): the pair sums of tisph_tpu_torch/models/wcsph_legacy.py.
//
// No Pallas kernel stands behind them: tisph_tpu runs them as jnp sweeps
// over fixed-shape windows of run_cap lanes per stencil row
// (tisph_tpu/models/wcsph_legacy.py:50-93 through
// tisph_tpu/ops/neighbors.py:142-235), one jit a step.  The plain versions
// are legacy_density_sweep and legacy_force_sweep in
// tisph_tpu_torch/ops/neighbors.py.
//
// - density: rho_i = rho0 sum over fluid j of m_V W_ij, no self term;
// - force: gravity -9.80 on the last axis, plus over every neighbour j
//   the Laplacian viscosity 2 (dim + 2) nu (mass / rho_j) (v_ij . r) /
//   (r^2 + 0.01 h^2) grad W, minus the fluid pressure term rho0 m_V
//   (p_i / rho_i^2 + p_j / rho_j^2) grad W, minus the boundary term
//   rho0 V_j (p_i / rho_i^2) grad W.
// A pair counts when r^2 < h^2 (r^2 from f32 differences) and j != i, as
// tisph_tpu tests it (ops/neighbors.py:160-163).  Rows off the fluid
// family write 0.
//
// Design.  One thread per row, over the row's 3^(dim-1) sort-time stencil
// runs [bounds[c_lo], bounds[c_hi + 1]) from the rebuild's ids and bounds,
// each walked to its end: no run cap, so no overflow to check and nothing
// for the host to read.  W and grad W are the piecewise cubic spline of
// tisph_tpu_torch/ops/kernels.py (tisph_tpu's jnp sweep uses the same),
// operation for operation: q = sqrt(r^2) / h, grad W = mag (x_ij / max(r h,
// 1e-5 h)), 0 for r <= 1e-5.  sweep_common.cuh's branch-free spline, whose
// q comes from rsqrtf, missed the force tolerance against the plain
// version (4.9e-5 of max|dv| on demo_2d after 500 steps, the limit 5e-6:
// the pressure terms cancel to a residual far below each term).  What
// bounds it on this card is what bounds kernel A with one thread per row
// (csrc/sweeps.cu): the candidate loop's latency, not bytes or
// operations; the solver's 6,300-row scene fills 50 CTAs.  A separate
// translation unit, so that csrc/sweeps.cu's modes stay bitwise as they
// are.  Inputs are float4 packs:
// - pos = [x, y, z or 0, fl] (fl: 1 on fluid rows, else 0);
// - vel = [vx, vy, vz or 0, rho] (force only);
// - aux = [p / rho^2, V, bd, 0] (bd: 1 on live non-fluid rows; force
//   only).

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using namespace tisph;

enum Mode { kDensity = 0, kForce = 1 };

constexpr int kThreads = 128;

struct LegacyArgs {
  float h;         // support length
  float h2;        // h^2: a pair counts when r^2 < h^2
  float k_sig;     // the spline's normalisation k / h^dim
  float m_v;       // 0.8 d^dim
  float visc;      // 2 (dim + 2) nu
  float mass;      // m_V rho0
  float eps_visc;  // 0.01 h^2
  float press;     // rho0 m_V
  float rho0;      // rest density
  float g_last;    // gravity on the last axis
};

// W(r) of ops/kernels.py's cubic_kernel: k (6 (q^3 - q^2) + 1) for
// q <= 0.5, k 2 (1 - q)^3 for q <= 1.
__device__ __forceinline__ float cubic_w(float q, float k) {
  const float inner = 6.0f * (q * q * q - q * q) + 1.0f;
  const float b = 1.0f - q;
  const float outer = 2.0f * b * b * b;
  return q <= 1.0f ? k * (q <= 0.5f ? inner : outer) : 0.0f;
}

// The factor of cubic_kernel_grad: grad W = mag (x_ij inv), with
// inv = 1 / max(r h, 1e-5 h); 0 for r <= 1e-5 or q > 1.
__device__ __forceinline__ float cubic_grad_mag(float q, float r, float k6) {
  const float inner = k6 * q * (3.0f * q - 2.0f);
  const float b = 1.0f - q;
  const float outer = -k6 * b * b;
  return (r > 1e-5f && q <= 1.0f) ? (q <= 0.5f ? inner : outer) : 0.0f;
}

template <int MODE, int DIM>
__global__ void __launch_bounds__(kThreads)
legacy_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
              const float4* __restrict__ aux, const int* __restrict__ ids,
              const int* __restrict__ bounds, const int* __restrict__ material,
              float* __restrict__ out, int n, GridArgs g, LegacyArgs a) {
  constexpr int kOut = MODE == kForce ? DIM : 1;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float* o = out + static_cast<long long>(i) * kOut;
  if (material[i] != 1) {  // off the fluid family
#pragma unroll
    for (int k = 0; k < kOut; ++k) o[k] = 0.0f;
    return;
  }
  int cx, cy, cz;
  decode_cell<DIM>(ids[i], g, cx, cy, cz);
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g.res_z - 1);
  const float4 pi = pos[i];
  float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
  float pr_i = 0.f;  // p_i / rho_i^2
  if (MODE == kForce) {
    vi = vel[i];
    pr_i = aux[i].x;
  }
  // force: the sums start at gravity, as the plain version's do
  float acc0 = 0.f;
  float acc1 = MODE == kForce && DIM == 2 ? a.g_last : 0.f;
  float acc2 = MODE == kForce && DIM == 3 ? a.g_last : 0.f;
  const float k6 = 6.0f * a.k_sig;
  const float eps_h = 1e-5f * a.h;
  constexpr int kOy = DIM == 3 ? 1 : 0;
  for (int ox = -1; ox <= 1; ++ox) {
    const int nx = cx + ox;
    if (nx < 0 || nx >= g.res0) continue;
    for (int oy = -kOy; oy <= kOy; ++oy) {
      const int ny = cy + oy;
      if (DIM == 3 && (ny < 0 || ny >= g.res1)) continue;
      const int base = nx * g.s0 + ny * g.s1;  // ny == 0 in 2D
      const int j1 = bounds[base + zhi + 1];
      for (int j = bounds[base + zlo]; j < j1; ++j) {
        if (j == i) continue;
        const float4 pj = pos[j];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        float r2 = dx * dx + dy * dy;
        if (DIM == 3) r2 += dz * dz;
        if (!(r2 < a.h2)) continue;
        const float r = sqrtf(r2);
        const float q = r / a.h;
        if (MODE == kDensity) {
          acc0 += pj.w * a.m_v * cubic_w(q, a.k_sig);
          continue;
        }
        const float4 vj = vel[j];
        const float4 aj = aux[j];
        float dot = (vi.x - vj.x) * dx + (vi.y - vj.y) * dy;
        if (DIM == 3) dot += (vi.z - vj.z) * dz;
        float coef = a.visc * (a.mass / vj.w) * dot / (r2 + a.eps_visc);
        coef = coef - pj.w * a.press * (pr_i + aj.x);
        coef = coef - aj.z * (a.rho0 * aj.y) * pr_i;
        const float mag = cubic_grad_mag(q, r, k6);
        const float inv = 1.0f / fmaxf(r * a.h, eps_h);
        acc0 += coef * (mag * (dx * inv));
        acc1 += coef * (mag * (dy * inv));
        if (DIM == 3) acc2 += coef * (mag * (dz * inv));
      }
    }
  }
  o[0] = MODE == kDensity ? a.rho0 * acc0 : acc0;
  if (MODE == kForce) {
    o[1] = acc1;
    if (DIM == 3) o[2] = acc2;
  }
}

template <int MODE, int DIM>
void launch(const float4* pos, const float4* vel, const float4* aux, const int* ids,
            const int* bounds, const int* material, float* out, int n, const GridArgs& g,
            const LegacyArgs& a, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  legacy_kernel<MODE, DIM><<<blocks, kThreads, 0, stream>>>(pos, vel, aux, ids, bounds,
                                                            material, out, n, g, a);
}

}  // namespace

// mode: 0 density (writes out[n]), 1 force (writes out[n * dim]); dim: 2
// or 3.  vel and aux are read by the force mode only.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown mode or dim.
extern "C" int tisph_legacy_sweep(int mode, int dim, const void* pos, const void* vel,
                                  const void* aux, const void* ids, const void* bounds,
                                  const void* material, void* out, int n, int res0,
                                  int res1, int res_z, int s0, int s1, float h, float h2,
                                  float k_sig, float m_v, float visc, float mass,
                                  float eps_visc, float press, float rho0, float g_last,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const float4*>(pos);
  const auto* v = static_cast<const float4*>(vel);
  const auto* x = static_cast<const float4*>(aux);
  const auto* id = static_cast<const int*>(ids);
  const auto* b = static_cast<const int*>(bounds);
  const auto* m = static_cast<const int*>(material);
  auto* o = static_cast<float*>(out);
  const GridArgs g{res0, res1, res_z, s0, s1};
  const LegacyArgs a{h, h2, k_sig, m_v, visc, mass, eps_visc, press, rho0, g_last};
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kDensity && dim == 2) {
    launch<kDensity, 2>(p, v, x, id, b, m, o, n, g, a, s);
  } else if (mode == kDensity && dim == 3) {
    launch<kDensity, 3>(p, v, x, id, b, m, o, n, g, a, s);
  } else if (mode == kForce && dim == 2) {
    launch<kForce, 2>(p, v, x, id, b, m, o, n, g, a, s);
  } else if (mode == kForce && dim == 3) {
    launch<kForce, 3>(p, v, x, id, b, m, o, n, g, a, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
