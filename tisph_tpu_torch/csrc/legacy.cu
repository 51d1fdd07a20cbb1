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
// Design.  L lanes serve a row (L a template constant, 4 or 16, picked
// by the wrapper from the row count and the dim: ops/cuda/legacy.py's
// legacy_launch_shape), as kernel A's lanes do (csrc/sweeps.cu).  A row
// walks its 3^(dim-1) sort-time stencil runs [bounds[c_lo], bounds[c_hi +
// 1]) from the rebuild's ids and bounds, each to its end: no run cap, so
// no overflow to check and nothing for the host to read.  Lane l of a row
// takes candidates j0 + l, j0 + l + L, ... of every run, so a row's lanes
// read 16 L consecutive bytes of pos per trip.  What bounds the kernel on
// this card is neither bytes nor operations but the candidate loop's
// latency, one dependent load after another: with one thread per row the
// solver's 6,304-row scene fills 50 CTAs of a 132-SM card and each thread
// walks about 80 candidates; L lanes cut a row's walk to 1 / L of it and
// give the card L times the threads: on an H100, demo_2d's density and
// force took 0.0330 and 0.0573 ms with one thread a row before lanes,
// 0.0083 and 0.0100 at 16 lanes; demo_3d after 252 steps 0.61x and 0.71x
// of that at 4 (PERF.md).  1 and 8 lanes were built and timed as well:
// one lane lost on every state, 8 won only at demo_3d's dense start, so
// neither is built.  Each lane keeps its own partial sums; the lanes add
// them by xor shuffles in a fixed order and lane 0 writes the row:
// deterministic, no atomics.  Gravity enters once, as lane 0's start
// value.  A row past n or off the fluid family keeps its lanes in the
// walk with empty runs and writes 0 from lane 0, so every shuffle sees all
// 32 lanes.
//
// The per-pair math is the same at every L, operation for operation: W
// and grad W are the piecewise cubic spline of
// tisph_tpu_torch/ops/kernels.py (tisph_tpu's jnp sweep uses the same): q
// = sqrt(r^2) / h, grad W = mag (x_ij / max(r h, 1e-5 h)), 0 for r <=
// 1e-5.  Only the order of a row's sum changes with L.  r^2 and q are
// rounded as the plain version's torch ops round them on the card (the
// squares and their sum one by one, 3D's columns as (x + z) + y; q = r
// times the f32 1 / h, torch's division by a Python scalar): a fluid row
// whose few neighbours sit near q = 1 has a density of terms (1 - q)^3,
// whose relative error is that of 1 - q, and nvcc's FMA in r^2 with r / h
// put demo_3d's splashed rows 5.4e-4 apart from the plain version after
// 252 steps, the limit 2e-5.
// sweep_common.cuh's branch-free spline, whose q comes from rsqrtf, missed
// the force tolerance against the plain version (4.9e-5 of max|dv| on
// demo_2d after 500 steps, the limit 5e-6: the pressure terms cancel to a
// residual far below each term).  A separate translation unit, so that
// csrc/sweeps.cu's modes stay bitwise as they are.  Inputs are float4
// packs:
// - pos = [x, y, z or 0, fl] (fl: 1 on fluid rows, else 0);
// - vel = [vx, vy, vz or 0, rho] (force only);
// - aux = [p / rho^2, V, bd, 0] (bd: 1 on live non-fluid rows; force
//   only).

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using namespace tisph;

enum Mode { kDensity = 0, kForce = 1 };

constexpr int kThreads = 128;  // threads per CTA, whatever the lanes per row
constexpr unsigned kFull = 0xffffffffu;

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

// r^2 of a pair as the plain version's torch.sum(r * r, dim=-1) rounds it
// on the card: each square rounded, 3D's columns added as (x + z) + y.
template <int DIM>
__device__ __forceinline__ float pair_r2(float dx, float dy, float dz) {
  const float xx = __fmul_rn(dx, dx);
  const float yy = __fmul_rn(dy, dy);
  return DIM == 3 ? __fadd_rn(__fadd_rn(xx, __fmul_rn(dz, dz)), yy) : __fadd_rn(xx, yy);
}

template <int MODE, int DIM, int L>
__global__ void __launch_bounds__(kThreads)
legacy_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
              const float4* __restrict__ aux, const int* __restrict__ ids,
              const int* __restrict__ bounds, const int* __restrict__ material,
              float* __restrict__ out, int n, GridArgs g, LegacyArgs a) {
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lanes per row: a power of two");
  constexpr int kOut = MODE == kForce ? DIM : 1;
  const int sub = threadIdx.x % L;  // this thread's lane of its row
  const int i = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool in_n = i < n;
  const bool fluid = in_n && material[i] == 1;
  int cx = 0, cy = 0, cz = 0;
  if (fluid) decode_cell<DIM>(ids[i], g, cx, cy, cz);
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g.res_z - 1);
  float4 pi = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
  float pr_i = 0.f;  // p_i / rho_i^2
  if (fluid) pi = pos[i];
  if (MODE == kForce && fluid) {
    vi = vel[i];
    pr_i = aux[i].x;
  }
  // force: lane 0's sums start at gravity, as the plain version's do
  const float g0 = MODE == kForce && sub == 0 ? a.g_last : 0.f;
  float acc0 = 0.f;
  float acc1 = DIM == 2 ? g0 : 0.f;
  float acc2 = DIM == 3 ? g0 : 0.f;
  const float k6 = 6.0f * a.k_sig;
  const float eps_h = 1e-5f * a.h;
  const float inv_h = __fdiv_rn(1.0f, a.h);  // torch's r / h: r times this
  constexpr int kOy = DIM == 3 ? 1 : 0;
  for (int ox = -1; ox <= 1; ++ox) {
    const int nx = cx + ox;
    if (!fluid || nx < 0 || nx >= g.res0) continue;
    for (int oy = -kOy; oy <= kOy; ++oy) {
      const int ny = cy + oy;
      if (DIM == 3 && (ny < 0 || ny >= g.res1)) continue;
      const int base = nx * g.s0 + ny * g.s1;  // ny == 0 in 2D
      const int j1 = bounds[base + zhi + 1];
      for (int j = bounds[base + zlo] + sub; j < j1; j += L) {
        if (j == i) continue;
        const float4 pj = pos[j];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        const float r2 = pair_r2<DIM>(dx, dy, dz);
        if (!(r2 < a.h2)) continue;
        const float r = __fsqrt_rn(r2);
        const float q = __fmul_rn(r, inv_h);
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
  // a row's lanes add their partial sums in a fixed order
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    acc0 += __shfl_xor_sync(kFull, acc0, o);
    if (MODE == kForce) acc1 += __shfl_xor_sync(kFull, acc1, o);
    if (MODE == kForce && DIM == 3) acc2 += __shfl_xor_sync(kFull, acc2, o);
  }
  if (!in_n || sub != 0) return;
  float* o = out + static_cast<long long>(i) * kOut;
  if (!fluid) {  // off the fluid family
#pragma unroll
    for (int k = 0; k < kOut; ++k) o[k] = 0.0f;
    return;
  }
  o[0] = MODE == kDensity ? a.rho0 * acc0 : acc0;
  if (MODE == kForce) {
    o[1] = acc1;
    if (DIM == 3) o[2] = acc2;
  }
}

// One call's arguments, as the kernel takes them.
struct Call {
  const float4 *pos, *vel, *aux;
  const int *ids, *bounds, *material;
  float* out;
  int n;
  GridArgs g;
  LegacyArgs a;
  cudaStream_t stream;
};

template <int MODE, int DIM, int L>
void launch(const Call& c) {
  constexpr int per_cta = kThreads / L;
  const int blocks = (c.n + per_cta - 1) / per_cta;
  legacy_kernel<MODE, DIM, L><<<blocks, kThreads, 0, c.stream>>>(
      c.pos, c.vel, c.aux, c.ids, c.bounds, c.material, c.out, c.n, c.g, c.a);
}

// False for a lane count that is not built: 4 and 16 are.
template <int MODE, int DIM>
bool launch_lanes(int lanes, const Call& c) {
  switch (lanes) {
    case 4: launch<MODE, DIM, 4>(c); return true;
    case 16: launch<MODE, DIM, 16>(c); return true;
    default: return false;
  }
}

}  // namespace

// mode: 0 density (writes out[n]), 1 force (writes out[n * dim]); dim: 2
// or 3; lanes: threads per row, 4 or 16.  vel and aux are read by
// the force mode only.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown mode, dim or lanes.
extern "C" int tisph_legacy_sweep(int mode, int dim, int lanes, const void* pos,
                                  const void* vel, const void* aux, const void* ids,
                                  const void* bounds, const void* material, void* out, int n,
                                  int res0, int res1, int res_z, int s0, int s1, float h,
                                  float h2, float k_sig, float m_v, float visc, float mass,
                                  float eps_visc, float press, float rho0, float g_last,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Call c{static_cast<const float4*>(pos),  static_cast<const float4*>(vel),
               static_cast<const float4*>(aux),  static_cast<const int*>(ids),
               static_cast<const int*>(bounds),  static_cast<const int*>(material),
               static_cast<float*>(out),         n,
               GridArgs{res0, res1, res_z, s0, s1},
               LegacyArgs{h, h2, k_sig, m_v, visc, mass, eps_visc, press, rho0, g_last},
               static_cast<cudaStream_t>(stream)};
  bool known = false;
  if (mode == kDensity && dim == 2) {
    known = launch_lanes<kDensity, 2>(lanes, c);
  } else if (mode == kDensity && dim == 3) {
    known = launch_lanes<kDensity, 3>(lanes, c);
  } else if (mode == kForce && dim == 2) {
    known = launch_lanes<kForce, 2>(lanes, c);
  } else if (mode == kForce && dim == 3) {
    known = launch_lanes<kForce, 3>(lanes, c);
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
