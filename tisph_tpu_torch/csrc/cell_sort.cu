// The rebuild's front for a small state, in one launch on one CTA, for
// Hopper (sm_90a): every row's flat cell id and a stable sort of the rows
// by it, the (sorted_ids, perm) that csrc/bounds.cu's rebuild then takes.
//
// Replaces tisph_tpu/ops/grid.py:107-145 (cell_coords, flat_cell_ids and
// jax.lax.sort_key_val(..., is_stable=True): XLA's sort, which has no
// Pallas counterpart) and, on the card, the port's torch sequence for it
// (ops/grid.py's cell_coords and flat_cell_ids, about ten elementwise
// launches, then torch.sort(stable=True): cub's device-wide onesweep
// radix sort, four 8-bit passes over the int32 keys with its histogram and
// tile-state memsets).  Contract: sorted_ids and perm equal that
// sequence's on the card bit for bit, so the state the rebuild gathers is
// the same.
//
// What bounds it: latency on one SM, not bytes.  At demo_2d's 6,304 rows
// it reads 12 B a row (x and material) and writes 12 B (an int32 id, an
// int64 perm), about 150 KB, 0.05 us at 3.35 TB/s; the time is the chain
// of dependent shared-memory steps and barriers of one CTA.  The design
// keeps that chain short and everything else out of device memory:
// - one CTA of 1,024 threads holds every row in registers, warp-striped:
//   item i of lane l in warp w is row w * 32 * kItems + 32 i + l, the order
//   a stable sort keeps.  Each thread computes the id of a row as it
//   loads it, so no id tensor and no scratch exists in device memory; the
//   outputs are the two tensors torch.sort would return;
// - the ids repeat torch's arithmetic on the card: x - start, then the
//   division by the cell size as torch's CUDA division by a Python scalar
//   does it, a multiply by the f32 reciprocal (inv_cell, computed by the
//   wrapper as torch does on the host: 1.0f / float(cell)); floorf, the
//   f32 -> int32 conversion (static_cast: cvt.rzi, NaN to 0, saturating,
//   as torch's .to(torch.int32)), the clamp into [0, res - 1], the strided
//   sum, and num_cells on MATERIAL_INVALID rows.  __fsub_rn and __fmul_rn
//   keep nvcc from contracting anything;
// - an LSD radix sort of 7-bit digits over bits [0, end_bit), end_bit the
//   bit length of num_cells (two passes for demo_2d's 9,375 cells, where
//   torch's sort makes four 8-bit passes over 32 bits).  A pass ranks each
//   warp's rows with __match_any_sync, one item at a time, against a
//   per-warp count of each digit in shared memory (a group's lowest lane
//   adds the group); one exclusive scan over the counts in (digit, warp)
//   order gives every (digit, warp) its first position; each row goes to
//   that plus its rank, in shared memory, and is read back warp-striped.
//   Rows of a digit keep their order (earlier warp, earlier item, lower
//   lane first), so each pass, and the sort, is stable.  Slots past n take
//   the key num_cells, so they follow every real row, the sentinel rows
//   among them;
// - the counts are padded to 33 a digit, so the lanes of a warp, which
//   count different digits, hit different banks.
// One tile is built, 8 rows a thread: 8,192 rows, the wrapper's
// SMALL_SORT_ROWS (ops/cuda/bounds.py).  Its shared memory (80.6 KiB)
// passes 48 KB and is asked for at each launch, as a launch inside a graph
// capture may.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;  // rows a thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 7;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kCountStride = kWarps + 1;            // a digit's per-warp counts, padded
constexpr int kCounts = kDigits * kWarps;           // in (digit, warp) order
constexpr int kCountsPerThread = kCounts / kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalid = -1;  // MATERIAL_INVALID of models/state.py

struct Grid {
  float start[3];  // domain_start rounded to f32
  float inv_cell;  // 1.0f / float(cell_size), rounded to f32
  int hi[3];       // res - 1
  int stride[3];   // GridSpec.strides
  int dim;         // 2 or 3
  int num_cells;   // the sentinel id
};

// keys and rows of the tile, the counts, the warps' scan totals
constexpr size_t kSmemBytes = (2 * kTile + kDigits * kCountStride + kWarps) * sizeof(unsigned);

// ops/grid.py's cell_coords then flat_cell_ids for one row
__device__ __forceinline__ unsigned cell_id(const float* __restrict__ x, int material, int row,
                                            const Grid& g) {
  if (material == kInvalid) return static_cast<unsigned>(g.num_cells);
  const float* r = x + static_cast<long long>(row) * g.dim;
  int id = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a < g.dim) {
      const float f = floorf(__fmul_rn(__fsub_rn(__ldg(r + a), g.start[a]), g.inv_cell));
      const int c = min(max(static_cast<int>(f), 0), g.hi[a]);
      id += c * g.stride[a];
    }
  }
  return static_cast<unsigned>(id);
}

// the count of (digit, warp) number c of the (digit, warp) order
__device__ __forceinline__ int count_at(int c) {
  return (c / kWarps) * kCountStride + c % kWarps;
}

// exclusive scan of the counts in (digit, warp) order, in place
__device__ void scan_counts(unsigned* counts, unsigned* warp_totals, int lane, int warp) {
  unsigned v[kCountsPerThread];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kCountsPerThread; ++j) {
    v[j] = counts[count_at(static_cast<int>(threadIdx.x) * kCountsPerThread + j)];
    sum += v[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned total = warp_totals[lane];
    unsigned w = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += t;
    }
    warp_totals[lane] = w - total;
  }
  __syncthreads();
  unsigned run = warp_totals[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kCountsPerThread; ++j) {
    counts[count_at(static_cast<int>(threadIdx.x) * kCountsPerThread + j)] = run;
    run += v[j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cell_sort_kernel(const float* __restrict__ x, const int* __restrict__ material, int n,
                 const Grid g, int end_bit, int* __restrict__ sorted_ids,
                 long long* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* s_keys = smem;
  int* s_rows = reinterpret_cast<int*>(smem + kTile);
  unsigned* s_counts = smem + 2 * kTile;
  unsigned* s_warp_totals = s_counts + kDigits * kCountStride;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int first = warp * 32 * kItems + lane;  // item i is row first + 32 i
  unsigned keys[kItems];
  int rows[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int row = first + 32 * i;
    rows[i] = row;
    keys[i] = row < n ? cell_id(x, __ldg(material + row), row, g)
                      : static_cast<unsigned>(g.num_cells);
  }
  for (int bit = 0; bit < end_bit; bit += kDigitBits) {
    for (int j = static_cast<int>(threadIdx.x); j < kDigits * kCountStride; j += kThreads) {
      s_counts[j] = 0;
    }
    __syncthreads();
    unsigned rank[kItems];  // among the warp's earlier rows of the same digit
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned d = (keys[i] >> bit) & (kDigits - 1);
      const unsigned peers = __match_any_sync(kFull, d);
      unsigned* count = s_counts + d * kCountStride + warp;
      const unsigned before = *count;
      rank[i] = before + __popc(peers & lanes_below);
      __syncwarp();
      if ((peers & lanes_below) == 0) *count = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    scan_counts(s_counts, s_warp_totals, lane, warp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned d = (keys[i] >> bit) & (kDigits - 1);
      const unsigned pos = s_counts[d * kCountStride + warp] + rank[i];
      s_keys[pos] = keys[i];
      s_rows[pos] = rows[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      keys[i] = s_keys[first + 32 * i];
      rows[i] = s_rows[first + 32 * i];
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = first + 32 * i;
    if (k < n) {
      sorted_ids[k] = static_cast<int>(keys[i]);
      perm[k] = rows[i];
    }
  }
}

}  // namespace

// n <= 8,192 rows.  x (n, dim) f32 and material (n,) int32 in, sorted_ids
// (n,) int32 and perm (n,) int64 out, all contiguous; start2, hi2 and
// stride2 are unread in 2D.
extern "C" int tisph_cell_sort(const void* x, const void* material, int n, int dim,
                               float start0, float start1, float start2, float inv_cell,
                               int hi0, int hi1, int hi2, int stride0, int stride1, int stride2,
                               int num_cells, int end_bit, void* sorted_ids, void* perm,
                               void* stream) {
  if ((dim != 2 && dim != 3) || n < 0 || n > kTile || end_bit < 1 || end_bit > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g{{start0, start1, start2}, inv_cell, {hi0, hi1, hi2},
               {stride0, stride1, stride2}, dim, num_cells};
  const cudaError_t err = cudaFuncSetAttribute(
      cell_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_sort_kernel<<<1, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(material), n, g, end_bit,
      static_cast<int*>(sorted_ids), static_cast<long long*>(perm));
  return static_cast<int>(cudaGetLastError());
}
