// The per-particle row ops of a WCSPH substep for Hopper (sm_90a): the
// two passes around the force sweep, as fused launches.
//
// - eos_pack, before the force sweep: the summed density kept on the
//   sort-time fluid rows, the reference-exact density mode on the current
//   fluid rows, the Tait EOS with its clamp rho <- max(rho, rho0), and the
//   force sweep's packs vel = [v, 0..., rho] and aux = [p / max(rho^2,
//   1e-12), fl m, m, 0];
// - advance, after it: symplectic Euler on the current fluid rows (v +=
//   dt dv, x += dt v), the domain-box clamp x in [lo, hi] with its
//   combined collision normal (x > hi: +1, x <= lo: -1 per axis) and the
//   reflection v -= (1 + c_f) (v . n^) n^ where |n| > 1e-6.
//
// No Pallas kernel stands behind them: tisph_tpu runs the same math as row
// ops on its (16, n) pack inside one jit, which XLA fuses into a few loop
// fusions (tisph_tpu/models/wcsph.py:255-264 with ops/pallas/sweeps.py:127-
// 133's repack_eos, and :283-311).  The plain versions are eos_packs_plain
// and advance_plain in tisph_tpu_torch/ops/forces.py, a sequence of some
// 17 and 28 PyTorch launches; this file gives each sequence one launch.
//
// Design.  One thread per row, each row's inputs read once and its outputs
// written once: both passes are bound by bytes (about 73 and 64 bytes a 3D
// row), far below a microsecond of the card's memory time at 195,300 rows,
// so what a launch costs is its start and tail.  The outputs are bitwise
// the plain sequence's on the card, which fixes the arithmetic:
// - every product and sum is __fmul_rn / __fadd_rn / __fsub_rn, so that
//   nvcc contracts nothing into an FMA (torch runs v + dt dv as two
//   kernels, two roundings); divisions and the square root are IEEE
//   (__fdiv_rn, __fsqrt_rn), never fast math;
// - a scalar divisor is a multiply by its f32 reciprocal, as torch's CUDA
//   division by a Python scalar is (rho / rho0 = rho * (1 / rho0));
// - the integer power is ops/eos.py's square-and-multiply, a non-integer
//   one powf with an f32 exponent, as torch's pow;
// - the clamps pass a NaN through (torch.clamp does; fmaxf would not), so
//   a blown-up row stays NaN for nan_count to find; comparisons with a NaN
//   are false, as torch.where's are;
// - v . n^ is summed as torch.sum(dim=-1) sums 2 or 3 columns on the card
//   (a block-x reduction of two threads: columns 0 and 2 on one, column 1
//   on the other, each term entering as 0 + p, so a -0 sum is +0).
// Its own translation unit, so that no flag or inline here moves the bits
// of the sweep kernels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFluid = 1;  // MATERIAL_FLUID of models/state.py

struct EosArgs {
  float rho0;       // rest density: the EOS clamp
  float inv_rho0;   // 1 / rho0 rounded to f32: ratio = rho * inv_rho0
  float stiffness;  // B
  float exponent;   // gamma, for powf
  int int_exp;      // gamma as an integer in [1, 16], else 0 (powf)
  int exact;        // reference_exact: rho <- m W(0) on current fluid rows
  float w0;         // W(0) = k / h^dim
};

struct AdvanceArgs {
  float dt;
  float lo[3];  // the f32 box of ops/forces.py::domain_box
  float hi[3];
  float cf;     // 1 + c_f rounded to f32
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

// torch.sum(p, dim=-1) over DIM = 2 or 3 columns, in the card's order
template <int DIM>
__device__ __forceinline__ float row_sum(const float (&p)[DIM]) {
  float s = __fadd_rn(0.0f, p[0]);
  if (DIM == 3) s = __fadd_rn(s, __fadd_rn(0.0f, p[DIM - 1]));
  return __fadd_rn(s, __fadd_rn(0.0f, p[1]));
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    eos_pack_kernel(int n, const float* __restrict__ rho_in, const float* __restrict__ density,
                    const uint8_t* __restrict__ fluid, const float* __restrict__ flm,
                    const int* __restrict__ material, const float* __restrict__ mass,
                    const float* __restrict__ v, float* __restrict__ rho_out,
                    float* __restrict__ p_out, float4* __restrict__ vel,
                    float4* __restrict__ aux, EosArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float m = mass[i];
  // the sort-time fluid rows keep the sweep's sum, the others their own
  float rho = fluid[i] ? rho_in[i] : density[i];
  if (a.exact && material[i] == kFluid) rho = __fmul_rn(m, a.w0);
  rho = clamp_min(rho, a.rho0);
  const float ratio = __fmul_rn(rho, a.inv_rho0);
  const float pw = a.int_exp > 0 ? integer_pow(ratio, a.int_exp) : powf(ratio, a.exponent);
  const float p = __fmul_rn(a.stiffness, __fsub_rn(pw, 1.0f));
  const float p_rho2 = __fdiv_rn(p, clamp_min(__fmul_rn(rho, rho), 1e-12f));
  rho_out[i] = rho;
  p_out[i] = p;
  const float* vi = v + static_cast<int64_t>(i) * DIM;
  vel[i] = make_float4(vi[0], vi[1], DIM == 3 ? vi[DIM - 1] : 0.0f, rho);
  aux[i] = make_float4(p_rho2, flm[i], m, 0.0f);
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    advance_kernel(int n, const float* __restrict__ x, const float* __restrict__ v,
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
    float nrm[DIM], sq[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vs[d] = __fadd_rn(vs[d], __fmul_rn(a.dt, dv[row + d]));
      xs[d] = __fadd_rn(xs[d], __fmul_rn(a.dt, vs[d]));
      nrm[d] = __fadd_rn(xs[d] > a.hi[d] ? 1.0f : 0.0f, xs[d] <= a.lo[d] ? -1.0f : 0.0f);
      sq[d] = __fmul_rn(nrm[d], nrm[d]);
      xs[d] = isnan(xs[d]) ? xs[d] : fminf(fmaxf(xs[d], a.lo[d]), a.hi[d]);
    }
    const float n_len = __fsqrt_rn(row_sum<DIM>(sq));
    const float len_c = fmaxf(n_len, 1e-6f);
    float nh[DIM], vn[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      nh[d] = __fdiv_rn(nrm[d], len_c);
      vn[d] = __fmul_rn(vs[d], nh[d]);
    }
    if (n_len > 1e-6f) {
      const float s = __fmul_rn(a.cf, row_sum<DIM>(vn));
#pragma unroll
      for (int d = 0; d < DIM; ++d) vs[d] = __fsub_rn(vs[d], __fmul_rn(s, nh[d]));
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

// dim: 2 or 3; fluid is a bool (one byte) array.  Writes rho_out and p_out
// (n,) and the packs vel and aux (n, 4).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for another dim.
extern "C" int tisph_eos_pack(int dim, int n, const void* rho_in, const void* density,
                              const void* fluid, const void* flm, const void* material,
                              const void* mass, const void* v, void* rho_out, void* p_out,
                              void* vel, void* aux, float rho0, float inv_rho0,
                              float stiffness, float exponent, int int_exp, int exact,
                              float w0, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const EosArgs a{rho0, inv_rho0, stiffness, exponent, int_exp, exact, w0};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rho_in);
  const auto* d = static_cast<const float*>(density);
  const auto* fl = static_cast<const uint8_t*>(fluid);
  const auto* fm = static_cast<const float*>(flm);
  const auto* mat = static_cast<const int*>(material);
  const auto* m = static_cast<const float*>(mass);
  const auto* vv = static_cast<const float*>(v);
  auto* ro = static_cast<float*>(rho_out);
  auto* po = static_cast<float*>(p_out);
  auto* ve = static_cast<float4*>(vel);
  auto* ax = static_cast<float4*>(aux);
  if (dim == 2) {
    eos_pack_kernel<2><<<blocks(n), kThreads, 0, s>>>(n, r, d, fl, fm, mat, m, vv, ro, po, ve,
                                                      ax, a);
  } else if (dim == 3) {
    eos_pack_kernel<3><<<blocks(n), kThreads, 0, s>>>(n, r, d, fl, fm, mat, m, vv, ro, po, ve,
                                                      ax, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dim: 2 or 3.  Reads x, v, dv (n, dim) and the current material, writes
// x_out and v_out (n, dim); rows off the fluid family are copied.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another dim.
extern "C" int tisph_advance(int dim, int n, const void* x, const void* v, const void* dv,
                             const void* material, void* x_out, void* v_out, float dt,
                             float lo0, float lo1, float lo2, float hi0, float hi1, float hi2,
                             float cf, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const AdvanceArgs a{dt, {lo0, lo1, lo2}, {hi0, hi1, hi2}, cf};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* vv = static_cast<const float*>(v);
  const auto* dd = static_cast<const float*>(dv);
  const auto* mat = static_cast<const int*>(material);
  auto* xo = static_cast<float*>(x_out);
  auto* vo = static_cast<float*>(v_out);
  if (dim == 2) {
    advance_kernel<2><<<blocks(n), kThreads, 0, s>>>(n, xx, vv, dd, mat, xo, vo, a);
  } else if (dim == 3) {
    advance_kernel<3><<<blocks(n), kThreads, 0, s>>>(n, xx, vv, dd, mat, xo, vo, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
