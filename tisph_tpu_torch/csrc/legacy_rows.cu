// The per-particle row ops of a legacy (V1, WCSPHLegacy) step for Hopper
// (sm_90a): the three passes around its two pair sums, as fused launches.
//
// - legacy_pos_pack, after the rebuild: the sums' pos = [x, 0..., fl]
//   pack of the sorted state, fl 1 on fluid rows, else 0;
// - legacy_eos_pack, between the sums: the density sum kept on fluid rows
//   (the others keep their stored one), the Tait EOS with its clamp rho <-
//   max(rho, rho0), and the force sum's packs vel = [v, 0..., rho] and
//   aux = [p / (rho rho), V, bd, 0], bd 1 on live rows off the fluid
//   family;
// - legacy_advance, after the force sum: symplectic Euler on fluid rows
//   (v += dt dv, x += dt v), then, unless reference_exact, the per-axis
//   clamp into [lo, hi] with v -= (1 + c_f) v on each component whose x
//   was outside (x < lo or x > hi).
//
// No Pallas kernel stands behind them: tisph_tpu runs the same math as row
// ops inside its legacy step's jit (tisph_tpu/models/wcsph_legacy.py:51,
// :60-76 and :98-122).  The plain versions are ops/neighbors.py's
// legacy_pos and ops/forces.py's legacy_eos_pack_plain and
// legacy_advance_plain, sequences of 5, 22 and 17 PyTorch launches.
//
// Separate from csrc/pointwise.cu, the V2 substep's passes, because V1
// differs exactly where those kernels would branch: aux holds V and bd,
// not fl m and m; p / rho^2 has no 1e-12 floor; the clamp reflects each
// violating component on its own with x < lo, not along a combined normal
// with x <= lo.  The V2 paths run none of this file.
//
// Design, as pointwise.cu's: one thread per row, each row's inputs read
// once and its outputs written once (about 20, 60 and 44 bytes a 2D row),
// so what a launch costs is its start and tail.  The outputs are bitwise
// the plain sequence's on the card, which fixes the arithmetic:
// - every product and sum is __fmul_rn / __fadd_rn / __fsub_rn, so that
//   nvcc contracts nothing into an FMA; the division p / (rho rho) is
//   IEEE (__fdiv_rn), never fast math;
// - a scalar divisor is a multiply by its f32 reciprocal, as torch's CUDA
//   division by a Python scalar is (rho / rho0 = rho * (1 / rho0));
// - the integer power is ops/eos.py's square-and-multiply, a non-integer
//   one powf with an f32 exponent, as torch's pow;
// - the clamps pass a NaN through (torch.clamp does; fmaxf would not);
//   comparisons with a NaN are false, as torch.where's are.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFluid = 1;     // MATERIAL_FLUID of models/state.py
constexpr int kInvalid = -1;  // MATERIAL_INVALID

struct EosArgs {
  float rho0;       // rest density: the EOS clamp
  float inv_rho0;   // 1 / rho0 rounded to f32: ratio = rho * inv_rho0
  float stiffness;  // B
  float exponent;   // gamma, for powf
  int int_exp;      // gamma as an integer in [1, 16], else 0 (powf)
};

struct AdvanceArgs {
  float dt;
  float lo[3];  // the f32 box of ops/forces.py::domain_box
  float hi[3];
  float cf;     // 1 + c_f rounded to f32
  int clamp;    // 0 under reference_exact: the reference's V1 never clamps
};

// torch.clamp(v, min=lo): a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// x^y by square-and-multiply in ops/eos.py's order (XLA's integer_pow)
__device__ __forceinline__ float integer_pow(float x, int y) {
  float acc = x;
  bool first = true;
  while (y > 0) {
    if (y & 1) {
      acc = first ? x : __fmul_rn(acc, x);
      first = false;
    }
    y >>= 1;
    if (y > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    legacy_pos_kernel(int n, const float* __restrict__ x, const int* __restrict__ material,
                      float4* __restrict__ pos) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* xi = x + static_cast<int64_t>(i) * DIM;
  pos[i] = make_float4(xi[0], xi[1], DIM == 3 ? xi[DIM - 1] : 0.0f,
                       material[i] == kFluid ? 1.0f : 0.0f);
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    legacy_eos_kernel(int n, const float* __restrict__ acc, const float* __restrict__ density,
                      const int* __restrict__ material, const float* __restrict__ volume,
                      const float* __restrict__ v, float* __restrict__ rho_out,
                      float* __restrict__ p_out, float4* __restrict__ vel,
                      float4* __restrict__ aux, EosArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int mat = material[i];
  // fluid rows keep the sum, the others their own
  float rho = mat == kFluid ? acc[i] : density[i];
  rho = clamp_min(rho, a.rho0);
  const float ratio = __fmul_rn(rho, a.inv_rho0);
  const float pw = a.int_exp > 0 ? integer_pow(ratio, a.int_exp) : powf(ratio, a.exponent);
  const float p = __fmul_rn(a.stiffness, __fsub_rn(pw, 1.0f));
  const float p_rho2 = __fdiv_rn(p, __fmul_rn(rho, rho));
  const float bd = mat != kFluid && mat != kInvalid ? 1.0f : 0.0f;
  rho_out[i] = rho;
  p_out[i] = p;
  const float* vi = v + static_cast<int64_t>(i) * DIM;
  vel[i] = make_float4(vi[0], vi[1], DIM == 3 ? vi[DIM - 1] : 0.0f, rho);
  aux[i] = make_float4(p_rho2, volume[i], bd, 0.0f);
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    legacy_advance_kernel(int n, const float* __restrict__ x, const float* __restrict__ v,
                          const float* __restrict__ dv, const int* __restrict__ material,
                          float* __restrict__ x_out, float* __restrict__ v_out, AdvanceArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t row = static_cast<int64_t>(i) * DIM;
  float xs[DIM], vs[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    xs[d] = x[row + d];
    vs[d] = v[row + d];
  }
  if (material[i] == kFluid) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vs[d] = __fadd_rn(vs[d], __fmul_rn(a.dt, dv[row + d]));
      xs[d] = __fadd_rn(xs[d], __fmul_rn(a.dt, vs[d]));
      if (a.clamp) {
        const bool out = xs[d] < a.lo[d] || xs[d] > a.hi[d];
        xs[d] = isnan(xs[d]) ? xs[d] : fminf(fmaxf(xs[d], a.lo[d]), a.hi[d]);
        if (out) vs[d] = __fsub_rn(vs[d], __fmul_rn(a.cf, vs[d]));
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    x_out[row + d] = xs[d];
    v_out[row + d] = vs[d];
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// dim: 2 or 3.  Reads x (n, dim) and the material, writes pos (n, 4).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for another dim.
extern "C" int tisph_legacy_pos_pack(int dim, int n, const void* x, const void* material,
                                     void* pos, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* mat = static_cast<const int*>(material);
  auto* po = static_cast<float4*>(pos);
  if (dim == 2) {
    legacy_pos_kernel<2><<<blocks(n), kThreads, 0, s>>>(n, xx, mat, po);
  } else if (dim == 3) {
    legacy_pos_kernel<3><<<blocks(n), kThreads, 0, s>>>(n, xx, mat, po);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dim: 2 or 3.  Reads the density sum acc, the stored density, the
// material, the volume (n,) and v (n, dim); writes rho_out and p_out (n,)
// and the packs vel and aux (n, 4).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for another dim.
extern "C" int tisph_legacy_eos_pack(int dim, int n, const void* acc, const void* density,
                                     const void* material, const void* volume, const void* v,
                                     void* rho_out, void* p_out, void* vel, void* aux,
                                     float rho0, float inv_rho0, float stiffness,
                                     float exponent, int int_exp, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const EosArgs a{rho0, inv_rho0, stiffness, exponent, int_exp};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ac = static_cast<const float*>(acc);
  const auto* d = static_cast<const float*>(density);
  const auto* mat = static_cast<const int*>(material);
  const auto* vol = static_cast<const float*>(volume);
  const auto* vv = static_cast<const float*>(v);
  auto* ro = static_cast<float*>(rho_out);
  auto* po = static_cast<float*>(p_out);
  auto* ve = static_cast<float4*>(vel);
  auto* ax = static_cast<float4*>(aux);
  if (dim == 2) {
    legacy_eos_kernel<2><<<blocks(n), kThreads, 0, s>>>(n, ac, d, mat, vol, vv, ro, po, ve, ax,
                                                        a);
  } else if (dim == 3) {
    legacy_eos_kernel<3><<<blocks(n), kThreads, 0, s>>>(n, ac, d, mat, vol, vv, ro, po, ve, ax,
                                                        a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dim: 2 or 3.  Reads x, v, dv (n, dim) and the material, writes x_out and
// v_out (n, dim); rows off the fluid family are copied, and clamp = 0
// leaves the box out.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another dim.
extern "C" int tisph_legacy_advance(int dim, int n, const void* x, const void* v,
                                    const void* dv, const void* material, void* x_out,
                                    void* v_out, float dt, float lo0, float lo1, float lo2,
                                    float hi0, float hi1, float hi2, float cf, int clamp,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const AdvanceArgs a{dt, {lo0, lo1, lo2}, {hi0, hi1, hi2}, cf, clamp};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* vv = static_cast<const float*>(v);
  const auto* dd = static_cast<const float*>(dv);
  const auto* mat = static_cast<const int*>(material);
  auto* xo = static_cast<float*>(x_out);
  auto* vo = static_cast<float*>(v_out);
  if (dim == 2) {
    legacy_advance_kernel<2><<<blocks(n), kThreads, 0, s>>>(n, xx, vv, dd, mat, xo, vo, a);
  } else if (dim == 3) {
    legacy_advance_kernel<3><<<blocks(n), kThreads, 0, s>>>(n, xx, vv, dd, mat, xo, vo, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
