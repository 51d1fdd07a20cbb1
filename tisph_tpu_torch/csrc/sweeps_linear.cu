// WCSPH neighbour sweeps over the linear layout (density, force) for
// Hopper (sm_90a).
//
// Replaces tisph_tpu/ops/pallas/sweeps.py::_sweep_kernel (sweeps.py:384),
// the TPU's linear-layout sweep, in its density and force modes; the pair
// math is that kernel's _tile_math (sweeps.py:181-297), shared with kernel
// A (csrc/sweeps.cu) through sweep_common.cuh, mirrored by the plain
// versions density_sweep_linear and force_sweep_linear in
// tisph_tpu_torch/ops/neighbors.py.
//
// Layout: one CTA per block of 128 consecutive i rows (SweepConfig
// .block_size's default).  For each of the 3^(dim-1) stencil rows the
// block shares one candidate window of the sorted j array: from the first
// j with id >= min c_lo to past the last j with id <= max c_hi, extremes
// over the block's active rows whose stencil row stays in the grid
// (grid.block_window_bounds).  A j of the window is a candidate of row i
// iff its sort-time id lies in i's own range [c_lo, c_hi] of that row
// (sweeps.py:483), so the pair set is kernel A's.
//
// What bounds it on this card: not the device-memory bytes (each j is
// read once per window, and the windows of neighbouring blocks overlap
// and hit L2) but the instructions of the candidate loop: every warp
// walks the j of the shared windows, most of them outside h.  The tiling
// answers that in two ways:
// - the CTA computes its windows itself (a shared-memory min/max over its
//   rows, then two reads of the CSR bounds of kernel B per stencil row),
//   so no pass over the blocks runs on the host's launch queue;
// - threads load each tile of T = 128 j (pos and id, plus vel and aux in
//   the force mode) cooperatively and coalesced into shared memory, and
//   every thread then reads the same element (a broadcast, no bank
//   conflicts).  Each warp first counts, with two warp reductions, where
//   its own id range [min c_lo, max c_hi] starts and ends in the tile
//   (the ids of a window ascend), and walks only that sub-range: a block
//   that straddles two grid columns has a window that runs from column
//   a's z_lo to column b's z_hi, and its warps skip the part that is
//   neither's.
// Threads outside the consumer family (fluid rows), the inactive tail and
// the ragged last block load tiles and reach every barrier; they only
// accumulate nothing and write 0.  The window loop runs to its end: no
// window cap (the TPU's VMEM bound) and no start quantisation (its DMA
// alignment).  Double-buffered loads (cp.async or TMA) are later work.
//
// i's cell is decoded from its sort-time id; the TPU kernel derives it
// from x by an f32 divide (sweeps.py:410-417), which gives the same cell
// at a per-substep rebuild (R = 1), the only cadence of this layout: the
// ids came from the same x through the same floor((x - start) / cell).
//
// Numerics are kernel A's: density folds the self term in through j == i;
// in the force mode dx is bitwise 0 for the self pair (x_i is read from
// pos, x_j from the shared copy of the same bits) and the rsqrt clamp
// keeps coef finite; k_sig (k_sig / h) is one multiply per i after the
// sum, gravity is added once per fluid i; pairs with q >= 1 are skipped
// (every term is exactly 0 there); FAST = fast_math puts __fdividef on
// the two viscosity divides.
//
// The i rows are all rows of the j array.  The TPU kernel's other caller,
// the sharded windowed step, passes a row slice of it (_run_sweep(ipack=
// ...), sweeps.py:545-551); that caller is not ported, and with it comes
// an offset on the i index.

#include <climits>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using namespace tisph;

enum Mode { kDensity = 0, kForce = 1 };

constexpr int kBlock = 128;  // i rows per CTA, one per thread
constexpr int kTile = 128;   // j rows per shared-memory tile
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == kBlock, "the tile load gives each thread one j");

// Inclusive cell-id range [lo, hi] of stencil row k (offsets in the order
// of grid._row_offsets: axis 0 outer) for a row in cell (cx, cy, z in
// [zlo, zhi]); the empty range [num_cells, -1] when the row is not taken
// or the stencil row leaves the grid.
template <int DIM>
__device__ __forceinline__ void row_range(int k, bool take, int cx, int cy, int zlo,
                                          int zhi, const GridArgs& g, int num_cells,
                                          int& lo, int& hi) {
  const int nx = cx + (DIM == 3 ? k / 3 : k) - 1;
  const int ny = DIM == 3 ? cy + k % 3 - 1 : 0;
  const bool valid = take && nx >= 0 && nx < g.res0 &&
                     (DIM == 2 || (ny >= 0 && ny < g.res1));
  const int base = nx * g.s0 + ny * g.s1;  // s1 == 0 in 2D
  lo = valid ? base + zlo : num_cells;
  hi = valid ? base + zhi : -1;
}

template <int MODE, int DIM, bool FAST>
__global__ void __launch_bounds__(kBlock)
linear_sweep_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
                    const float4* __restrict__ aux, const int* __restrict__ ids,
                    const int* __restrict__ bounds, const int* __restrict__ material,
                    float* __restrict__ out, int* __restrict__ windows, int n,
                    int num_cells, GridArgs g, PhysArgs p) {
  constexpr bool kGrad = MODE == kForce;
  constexpr int kRows = DIM == 3 ? 9 : 3;
  __shared__ float4 s_pos[kTile];
  __shared__ float4 s_vel[kGrad ? kTile : 1];
  __shared__ float4 s_aux[kGrad ? kTile : 1];
  __shared__ int s_id[kTile];
  __shared__ int s_lo[kWarps][kRows];
  __shared__ int s_hi[kWarps][kRows];
  __shared__ int s_start[kRows];
  __shared__ int s_end[kRows];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i = blockIdx.x * kBlock + t;
  const bool in_range = i < n;
  const int id = in_range ? ids[i] : num_cells;
  const bool active = id < num_cells;
  const bool consumer = in_range && active && material[i] == 1;

  // sort-time cell of i, decoded from its id
  int cx = 0, cy = 0, cz = 0;
  if (active) decode_cell<DIM>(id, g, cx, cy, cz);
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g.res_z - 1);

  // the block's windows: min c_lo / max c_hi over its active rows, per
  // stencil row, then the CSR bounds of the two ends
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    int lo, hi;
    row_range<DIM>(k, active, cx, cy, zlo, zhi, g, num_cells, lo, hi);
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      s_lo[warp][k] = lo;
      s_hi[warp][k] = hi;
    }
  }
  __syncthreads();
  if (t < kRows) {
    int lo = s_lo[0][t], hi = s_hi[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      lo = min(lo, s_lo[w][t]);
      hi = max(hi, s_hi[w][t]);
    }
    // lo in [0, num_cells] and hi + 1 in [0, num_cells]: inside bounds
    const int start = bounds[lo];
    const int end = bounds[hi + 1];
    s_start[t] = start;
    s_end[t] = end;
    if (windows != nullptr) {
      windows[(blockIdx.x * kRows + t) * 2 + 0] = start;
      windows[(blockIdx.x * kRows + t) * 2 + 1] = end;
    }
  }
  __syncthreads();

  const float4 pi = consumer ? pos[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
  FluidRow fi{0.f, 0.f, 0.f};
  if (kGrad && consumer) {
    vi = vel[i];
    fi = fluid_row(vi, aux[i], p);
  }
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;

  for (int k = 0; k < kRows; ++k) {
    int lo, hi;  // this thread's range; empty off the consumer family
    row_range<DIM>(k, consumer, cx, cy, zlo, zhi, g, num_cells, lo, hi);
    const int wlo = __reduce_min_sync(kFull, lo);  // the warp's range
    const int whi = __reduce_max_sync(kFull, hi);
    const int end = s_end[k];
    for (int t0 = s_start[k]; t0 < end; t0 += kTile) {
      const int j = t0 + t;
      if (j < end) {
        s_pos[t] = pos[j];
        s_id[t] = ids[j];
        if (kGrad) {
          s_vel[t] = vel[j];
          s_aux[t] = aux[j];
        }
      } else {
        s_id[t] = INT_MAX;  // sorts after every id of the window
      }
      __syncthreads();
      // ids ascend over the tile, so the j below the warp's range and
      // those up to its end are two prefixes: count both
      int below = 0, upto = 0;
#pragma unroll
      for (int c = 0; c < kTile / 32; ++c) {
        const int v = s_id[c * 32 + lane];
        below += v < wlo;
        upto += v <= whi;
      }
      below = __reduce_add_sync(kFull, below);
      upto = __reduce_add_sync(kFull, upto);
      for (int jj = below; jj < upto; ++jj) {
        const int idj = s_id[jj];
        if (idj < lo || idj > hi) continue;
        const float4 pj = s_pos[jj];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        Spline s;
        if (!spline<DIM>(dx, dy, dz, p.inv_h, s)) continue;
        if (!kGrad) {
          acc0 += pj.w * s.w;
          continue;
        }
        const float4 vj = s_vel[jj];
        const float4 aj = s_aux[jj];
        const float dneg = dot_neg<DIM, FAST>(vi, vj, dx, dy, dz, s.r2, p);
        const float coef = fluid_coef<FAST>(fi, vi, pj, vj, aj, dneg, s, p);
        acc0 += coef * dx;
        acc1 += coef * dy;
        if (DIM == 3) acc2 += coef * dz;
      }
      __syncthreads();  // the tile is read before the next one lands
    }
  }

  if (!in_range) return;
  if (kGrad) {
    out[i * DIM + 0] = consumer ? acc0 * p.fin + p.g[0] : 0.0f;
    out[i * DIM + 1] = consumer ? acc1 * p.fin + p.g[1] : 0.0f;
    if (DIM == 3) out[i * DIM + 2] = consumer ? acc2 * p.fin + p.g[2] : 0.0f;
  } else {
    out[i] = consumer ? acc0 * p.fin : 0.0f;
  }
}

template <int MODE, int DIM, bool FAST>
void launch(const void* pos, const void* vel, const void* aux, const void* ids,
            const void* bounds, const void* material, void* out, void* windows,
            int n, int num_cells, const GridArgs& g, const PhysArgs& p,
            cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  linear_sweep_kernel<MODE, DIM, FAST><<<blocks, kBlock, 0, stream>>>(
      static_cast<const float4*>(pos), static_cast<const float4*>(vel),
      static_cast<const float4*>(aux), static_cast<const int*>(ids),
      static_cast<const int*>(bounds), static_cast<const int*>(material),
      static_cast<float*>(out), static_cast<int*>(windows), n, num_cells, g, p);
}

}  // namespace

// mode: 0 density, 1 force; dim: 2 or 3; fast_math is read by the force
// mode, vel and aux only by it.  pos, vel, aux, ids and material hold n
// rows, bounds the ids' CSR bounds over num_cells + 1 entries; out holds
// n rows.  windows, if not null, receives each block's [start, end) per
// stencil row, (ceil(n / 128), 3^(dim-1), 2) int32.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown mode or dim.
extern "C" int tisph_linear_sweep(int mode, int dim, int fast_math, const void* pos,
                                  const void* vel, const void* aux, const void* ids,
                                  const void* bounds, const void* material, void* out,
                                  void* windows, int n, int res0, int res1,
                                  int res_z, int s0, int s1, int num_cells, float inv_h,
                                  float fin, float eps_visc, float visc_num,
                                  float nub_num, float coh_num, float gx, float gy,
                                  float gz, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const GridArgs g{res0, res1, res_z, s0, s1};
  const PhysArgs p{inv_h, fin, eps_visc, visc_num, nub_num, coh_num, {gx, gy, gz}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TISPH_ARGS pos, vel, aux, ids, bounds, material, out, windows, n, num_cells, g, p, st
  if (dim == 3 && mode == kDensity) {
    launch<kDensity, 3, false>(TISPH_ARGS);
  } else if (dim == 3 && mode == kForce && fast_math) {
    launch<kForce, 3, true>(TISPH_ARGS);
  } else if (dim == 3 && mode == kForce) {
    launch<kForce, 3, false>(TISPH_ARGS);
  } else if (dim == 2 && mode == kDensity) {
    launch<kDensity, 2, false>(TISPH_ARGS);
  } else if (dim == 2 && mode == kForce && fast_math) {
    launch<kForce, 2, true>(TISPH_ARGS);
  } else if (dim == 2 && mode == kForce) {
    launch<kForce, 2, false>(TISPH_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TISPH_ARGS
  return static_cast<int>(cudaGetLastError());
}
