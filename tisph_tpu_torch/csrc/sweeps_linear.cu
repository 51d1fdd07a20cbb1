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
// .block_size's default), one thread per row.  For each of the 3^(dim-1)
// stencil rows the block shares one candidate window of the sorted j
// array: from the first j with id >= min c_lo to past the last j with id
// <= max c_hi, extremes over the block's active rows whose stencil row
// stays in the grid (grid.block_window_bounds).  The CTA computes its
// windows itself (a shared-memory min/max over its rows, then two reads of
// the CSR bounds of kernel B per stencil row), so no pass over the blocks
// runs on the host's launch queue.
//
// What bounds it on this card: neither the device-memory bytes (each j is
// read once per window, and neighbouring blocks' windows overlap in L2)
// nor the f32 operations of the pairs inside h, but the latency and the
// instruction slots of the candidate loop, where four of five candidates fail
// q < 1.  The design spends shared memory on that loop:
// - the block's windows are one stream of `total` j, window k at flat
//   positions [off_k, off_k + end_k - start_k), copied into shared memory
//   in chunks of a fixed capacity with 16-byte cp.async (every pack row is
//   one aligned float4), so the data passes no register and a mean block
//   (1,300 to 2,500 j on demo_3d) needs two to five barrier pairs;
// - the candidates of row i in stencil row k are the contiguous run
//   [bounds[c_lo], bounds[c_hi + 1]) of the sorted array (ids ascend and
//   i's range is contiguous in id), kernel A's run, and it lies inside the
//   block's window k.  So a thread reads its 2 * 3^(dim-1) run ends once,
//   maps them to flat positions and walks, chunk by chunk, exactly the
//   part of its runs that the chunk holds: no id is staged or tested, and
//   the chunk loop holds no warp-wide operation.  Stencil rows in order
//   and j ascending inside a run is kernel A's order term for term (the
//   sums live in registers across chunks), so the two kernels' densities
//   are bitwise equal;
// - the force mode stages vel and aux beside pos, 48 bytes per j, so its
//   loads of the pairs inside h come from shared memory too;
// - what decides the rest is how many CTAs an SM holds: the chunks are
//   small (768 j x 16 B in the density mode, 512 j x 48 B in the force
//   mode), there is one buffer (the SM's other CTAs walk while this one
//   copies; a second buffer in flight only takes their room), and the
//   run ends live in shared memory, not in 18 registers.  Measured on
//   an H100 and rejected: a second buffer, reading vel and aux from device
//   memory for the pairs inside h only, and chunks of 2,048 (density) or
//   768 (force) j.
// Threads outside the consumer family (fluid rows), the inactive tail and
// the ragged last block help to copy and reach every barrier; they walk
// nothing and write 0.  An empty window [num_cells, -1] has length 0.
// There is no window cap (the TPU's VMEM bound) and no start quantisation
// (its DMA alignment).
//
// No tensor cores: r^2 must come from f32 differences, because a Gram
// product cancels at r^2 ~ h^2 << |x|^2 and TF32 keeps too few bits for
// it.  No TMA: a block's copies are 3^(dim-1) runs of unaligned start and
// data-dependent length, which cp.async serves element by element and a
// TMA tile of fixed shape does not.
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
// The i rows are the rows [row0, row0 + n) of the j array: all of it, or a
// slab shard's rows of its halo window, as the TPU kernel's sharded caller
// passes a row slice of the extended pack (_run_sweep(ipack=...),
// sweeps.py:545-551).  Block b holds rows row0 + 128 b on, and the windows
// output has ceil(n / 128) blocks.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using namespace tisph;

enum Mode { kDensity = 0, kForce = 1 };

constexpr int kBlock = 128;  // i rows per CTA, one per thread
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// j per shared-memory chunk: pos alone in the density mode, pos, vel and
// aux in the force mode
constexpr int kChunkDensity = 768;
constexpr int kChunkForce = 512;

template <int MODE>
constexpr int kChunkOf = MODE == kForce ? kChunkForce : kChunkDensity;
// resident CTAs per SM the compiler must leave registers for (the second
// launch bound); 1 leaves it free
template <int MODE>
constexpr int kMinCtasOf = MODE == kForce ? 1 : 12;
// float4 rows of dynamic shared memory a CTA asks for
template <int MODE>
constexpr int kChunkRowsOf = kChunkOf<MODE> * (MODE == kForce ? 3 : 1);

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

// A CTA's static shared memory: its windows and its rows' runs.
template <int ROWS>
struct BlockMeta {
  int lo[kWarps][ROWS];  // each warp's min c_lo and max c_hi per stencil row
  int hi[kWarps][ROWS];
  int off[ROWS + 1];     // flat position where window k starts
  int shift[ROWS];       // j - flat position inside window k
  // each row's runs as flat positions, a column per thread: 2 * ROWS
  // registers less through the chunk loop, which buys resident CTAs
  int run_lo[ROWS][kBlock];
  int run_hi[ROWS][kBlock];
};

template <int MODE, int DIM, bool FAST>
__global__ void __launch_bounds__(kBlock, kMinCtasOf<MODE>)
linear_sweep_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
                    const float4* __restrict__ aux, const int* __restrict__ ids,
                    const int* __restrict__ bounds, const int* __restrict__ material,
                    float* __restrict__ out, int* __restrict__ windows, int row0, int n,
                    int num_cells, GridArgs g, PhysArgs p) {
  constexpr bool kGrad = MODE == kForce;
  constexpr int kRows = DIM == 3 ? 9 : 3;
  constexpr int kChunk = kChunkOf<MODE>;
  static_assert(kRows <= 32, "one warp scans the window lengths");
  extern __shared__ float4 s_chunk[];  // pos, then vel and aux in the force mode
  float4* const s_pos = s_chunk;
  float4* const s_vel = s_chunk + kChunk;
  float4* const s_aux = s_chunk + 2 * kChunk;
  __shared__ BlockMeta<kRows> m;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i = row0 + blockIdx.x * kBlock + t;
  const bool in_range = i < row0 + n;
  const int id = in_range ? ids[i] : num_cells;
  const bool active = id < num_cells;
  const bool consumer = in_range && active && material[i] == 1;

  // sort-time cell of i, decoded from its id
  int cx = 0, cy = 0, cz = 0;
  if (active) decode_cell<DIM>(id, g, cx, cy, cz);
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g.res_z - 1);

  // Per stencil row: this thread's run, kernel A's (empty off the consumer
  // family; its two reads of the bounds stay in flight through the window
  // step), and the block's window: min c_lo / max c_hi over its active
  // rows, then the CSR bounds of the two ends
  int run_lo[kRows], run_hi[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    int lo, hi;
    row_range<DIM>(k, active, cx, cy, zlo, zhi, g, num_cells, lo, hi);
    const bool walk = consumer && hi >= lo;
    run_lo[k] = walk ? bounds[lo] : 0;
    run_hi[k] = walk ? bounds[hi + 1] : 0;
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      m.lo[warp][k] = lo;
      m.hi[warp][k] = hi;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int start = 0, len = 0;
    if (lane < kRows) {
      int lo = m.lo[0][lane], hi = m.hi[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        lo = min(lo, m.lo[w][lane]);
        hi = max(hi, m.hi[w][lane]);
      }
      // lo in [0, num_cells] and hi + 1 in [0, num_cells]: inside bounds
      start = bounds[lo];
      const int end = bounds[hi + 1];
      len = max(end - start, 0);  // an empty window has end < start
      if (windows != nullptr) {
        windows[(blockIdx.x * kRows + lane) * 2 + 0] = start;
        windows[(blockIdx.x * kRows + lane) * 2 + 1] = end;
      }
    }
    // the windows as one stream: the exclusive prefix sum of their lengths
    int upto = len;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const int v = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += v;
    }
    if (lane < kRows) {
      m.off[lane + 1] = upto;
      m.shift[lane] = start - (upto - len);
    }
    if (lane == 0) m.off[0] = 0;
  }
  __syncthreads();
  const int total = m.off[kRows];

  // the runs as flat positions of the stream: a run lies inside its
  // window, and an empty one stays empty wherever it lands
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    m.run_lo[k][t] = run_lo[k] - m.shift[k];
    m.run_hi[k][t] = run_hi[k] - m.shift[k];
  }

  const float4 pi = consumer ? pos[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
  FluidRow fi{0.f, 0.f, 0.f};
  if (kGrad && consumer) {
    vi = vel[i];
    fi = fluid_row(vi, aux[i], p);
  }
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;

  // A thread's flat positions only grow from chunk to chunk, so the window
  // of its next copy, w, only moves forward
  int w = 0;
  for (int c0 = 0; c0 < total; c0 += kChunk) {
    // the stream's chunk [c0, c0 + kChunk) into shared memory
    const int c1 = min(c0 + kChunk, total);
    for (int f = c0 + t; f < c1; f += kBlock) {
      while (f >= m.off[w + 1]) ++w;
      const int j = f + m.shift[w];
      __pipeline_memcpy_async(&s_pos[f - c0], &pos[j], sizeof(float4));
      if (kGrad) {
        __pipeline_memcpy_async(&s_vel[f - c0], &vel[j], sizeof(float4));
        __pipeline_memcpy_async(&s_aux[f - c0], &aux[j], sizeof(float4));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < kRows; ++k) {
      const int f1 = min(m.run_hi[k][t], c1);
      for (int f = max(m.run_lo[k][t], c0); f < f1; ++f) {
        const float4 pj = s_pos[f - c0];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float dz = pi.z - pj.z;
        Spline s;
        if (!spline<DIM>(dx, dy, dz, p.inv_h, s)) continue;
        if (!kGrad) {
          acc0 += pj.w * s.w;
          continue;
        }
        const float4 vj = s_vel[f - c0];
        const float4 aj = s_aux[f - c0];
        const float dneg = dot_neg<DIM, FAST>(vi, vj, dx, dy, dz, s.r2, p);
        const float coef = fluid_coef<FAST>(fi, vi, pj, vj, aj, dneg, s, p);
        acc0 += coef * dx;
        acc1 += coef * dy;
        if (DIM == 3) acc2 += coef * dz;
      }
    }
    __syncthreads();  // the chunk is walked before it is refilled
  }

  if (!in_range) return;
  const int o = i - row0;  // out holds the swept rows only
  if (kGrad) {
    out[o * DIM + 0] = consumer ? acc0 * p.fin + p.g[0] : 0.0f;
    out[o * DIM + 1] = consumer ? acc1 * p.fin + p.g[1] : 0.0f;
    if (DIM == 3) out[o * DIM + 2] = consumer ? acc2 * p.fin + p.g[2] : 0.0f;
  } else {
    out[o] = consumer ? acc0 * p.fin : 0.0f;
  }
}

// Returns cudaGetLastError() after the launch.  The chunks and the static
// arrays together stay inside the 48 KB every kernel may have, so no limit
// is raised.
template <int MODE, int DIM, bool FAST>
cudaError_t launch(const void* pos, const void* vel, const void* aux, const void* ids,
                   const void* bounds, const void* material, void* out, void* windows,
                   int row0, int n, int num_cells, const GridArgs& g, const PhysArgs& p,
                   cudaStream_t stream) {
  constexpr size_t kShared = kChunkRowsOf<MODE> * sizeof(float4);
  static_assert(kShared + sizeof(BlockMeta<DIM == 3 ? 9 : 3>) <= 48 * 1024,
                "larger chunks need cudaFuncAttributeMaxDynamicSharedMemorySize");
  const int blocks = (n + kBlock - 1) / kBlock;
  linear_sweep_kernel<MODE, DIM, FAST><<<blocks, kBlock, kShared, stream>>>(
      static_cast<const float4*>(pos), static_cast<const float4*>(vel),
      static_cast<const float4*>(aux), static_cast<const int*>(ids),
      static_cast<const int*>(bounds), static_cast<const int*>(material),
      static_cast<float*>(out), static_cast<int*>(windows), row0, n, num_cells, g, p);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 density, 1 force; dim: 2 or 3; fast_math is read by the force
// mode, vel and aux only by it.  pos, vel, aux, ids and material hold the
// arrays' rows, bounds the ids' CSR bounds over num_cells + 1 entries; the
// launch sweeps rows [row0, row0 + n) of them and out holds those n rows.
// windows, if not null, receives each block's [start, end) per stencil
// row, (ceil(n / 128), 3^(dim-1), 2) int32.  Returns the launch's error (0
// for none), or cudaErrorInvalidValue for an unknown mode or dim.
extern "C" int tisph_linear_sweep(int mode, int dim, int fast_math, const void* pos,
                                  const void* vel, const void* aux, const void* ids,
                                  const void* bounds, const void* material, void* out,
                                  void* windows, int row0, int n, int res0, int res1,
                                  int res_z, int s0, int s1, int num_cells, float inv_h,
                                  float fin, float eps_visc, float visc_num,
                                  float nub_num, float coh_num, float gx, float gy,
                                  float gz, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const GridArgs g{res0, res1, res_z, s0, s1};
  const PhysArgs p{inv_h, fin, eps_visc, visc_num, nub_num, coh_num, {gx, gy, gz}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TISPH_ARGS \
  pos, vel, aux, ids, bounds, material, out, windows, row0, n, num_cells, g, p, st
  cudaError_t err = cudaErrorInvalidValue;
  if (dim == 3 && mode == kDensity) {
    err = launch<kDensity, 3, false>(TISPH_ARGS);
  } else if (dim == 3 && mode == kForce && fast_math) {
    err = launch<kForce, 3, true>(TISPH_ARGS);
  } else if (dim == 3 && mode == kForce) {
    err = launch<kForce, 3, false>(TISPH_ARGS);
  } else if (dim == 2 && mode == kDensity) {
    err = launch<kDensity, 2, false>(TISPH_ARGS);
  } else if (dim == 2 && mode == kForce && fast_math) {
    err = launch<kForce, 2, true>(TISPH_ARGS);
  } else if (dim == 2 && mode == kForce) {
    err = launch<kForce, 2, false>(TISPH_ARGS);
  }
#undef TISPH_ARGS
  return static_cast<int>(err);
}
