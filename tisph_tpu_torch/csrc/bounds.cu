// The R-group rebuild after the cell sort, in one launch, for Hopper
// (sm_90a): the CSR cell bounds of the sorted ids and the reorder of every
// state field by the sort's permutation.
//
// Replaces tisph_tpu/ops/pallas/bounds.py:43 _bounds_kernel (the TPU's
// per-1024-cell compare-reduce, launched by csr_bounds_sorted there) and,
// in the same launch, the row gather of tisph_tpu/ops/grid.py:162 (one
// jnp.take of the bit-packed (n, 15) f32 state, which XLA runs).
// Contract: ids[0..n) ascending, inactive tail = num_cells, perm the
// stable sort's permutation; writes bounds[c] = #(ids < c) for c in
// [0, num_cells] and dst_f[k] = src_f[perm[k]] row by row for every field
// f.  Both are exact (integer counts, copied words), so the outputs equal
// the plain version's bit for bit.
//
// What bounds it: bytes.  On demo_3d (195,304 rows of 15 words, 475,001
// cells) a row moves 60 B read + 60 B written + 8 B of perm + 4 B of id,
// and the bounds 4 B a cell: 27.7 MB, 0.0083 ms at 3.35 TB/s.  The work
// per byte is a few integer compares, so the design is about keeping
// every CTA's share of the bytes equal and its dependent loads few.
//
// Two kinds of CTA share one grid, chosen by blockIdx.x:
// - bounds CTAs (the first ones, so they start first: they wait longest).
//   Cells and ids are cut by merge path: merging the cells 0..num_cells
//   with the sorted ids (id k before cell c iff ids[k] < c), CTA b owns
//   the merged positions [b D, (b+1) D), D = `items`, whatever mix of
//   cells and ids that is.  So no CTA's window of ids is ever longer than
//   D: the empty domain edge (about 380k of demo_3d's cells) and a cell
//   that holds thousands of particles cost the same per position, with no
//   staging overflow and no second path.  Warps 0 and 1 find the CTA's
//   two split points in device memory by a 32-ary search (32 probes a
//   round, 4 rounds at 195k ids, 5 at 1M; a binary search would be 18
//   dependent loads); the block stages its ids [a0, a1) into shared
//   memory with 16-byte cp.async (zero-filled past n), and each thread
//   counts its cells, c0 + tid + 256 j, by a binary search there and
//   writes them coalesced: bounds[c] = a0 + #(window < c), since every id
//   before a0 is < c and every id from a1 on is >= c.
// - gather CTAs: one thread per sorted row k, 256 rows a CTA.  It reads
//   perm[k] and then the row's words of every field from a field table
//   passed by value (up to nine (src, dst, width) entries, widths up to
//   3), all loads before all stores, so 13 or 15 independent loads are in
//   flight per thread.  Neighbouring threads write neighbouring rows.
//   Their reads are as local as the permutation: the state was sorted one
//   group before, so a row mostly moves a few places.
// The host decides nothing about the data: both kinds run in every launch
// (none of the gather kind for csr_bounds_sorted), and the wrapper reads
// no device value.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 9;
constexpr int kMaxWidth = 3;
constexpr unsigned kFull = 0xffffffffu;

struct Fields {
  const unsigned* src[kMaxFields];
  unsigned* dst[kMaxFields];
  int width[kMaxFields];
  int count;
};

// The merge-path split of diagonal d: how many ids are among the first d
// positions of the merge of ids[0..n) with the cells 0..m-1.  It is the
// first a in [max(0, d - m), min(d, n)) where ids[a] < d - 1 - a fails (or
// the upper end); that predicate is true, then false.  All 32 lanes of the
// warp call it with the same d and return the same a.
__device__ int merge_split(const int* __restrict__ ids, int n, int m, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - m), hi = min(d, n);
  while (hi > lo) {
    const int len = hi - lo;
    // probes lo + floor(j len / 32): every position once len <= 32
    const int p = lo + static_cast<int>((static_cast<long long>(lane) * len) >> 5);
    const bool before = __ldg(ids + p) < d - 1 - p;
    const int t = __popc(__ballot_sync(kFull, before));  // a prefix of the lanes
    const int p_last = __shfl_sync(kFull, p, t > 0 ? t - 1 : 0);
    const int p_next = __shfl_sync(kFull, p, t < 32 ? t : 31);
    if (t == 0) {
      hi = lo;
    } else {
      lo = p_last + 1;
      if (t < 32) hi = p_next;
    }
  }
  return lo;
}

__device__ void bounds_tile(const int* __restrict__ ids, int n, int num_cells,
                            int* __restrict__ bounds, int items, int* s_ids) {
  __shared__ int s_split[2];
  const int m = num_cells + 1;
  const int total = n + m;
  const int d0 = blockIdx.x * items;
  const int d1 = min(total, d0 + items);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int a = merge_split(ids, n, m, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_split[warp] = a;
  }
  __syncthreads();
  const int a0 = s_split[0], a1 = s_split[1];
  const int c0 = d0 - a0, c1 = d1 - a1;

  // ids[a0, a1) from the 16-byte aligned index below a0, in 4-id pieces
  const int base = a0 & ~3;
  const int pieces = (a1 - base + 3) >> 2;
  for (int q = threadIdx.x; q < pieces; q += kThreads) {
    const int g = base + 4 * q;
    const int valid = min(4, n - g);  // >= 1: g < a1 <= n
    __pipeline_memcpy_async(s_ids + 4 * q, ids + g, 16, 4 * (4 - valid));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int* w = s_ids + (a0 - base);
  const int len = a1 - a0;
  for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += kThreads) {
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (w[mid] < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bounds[c] = a0 + lo;
  }
}

__device__ void gather_rows(const long long* __restrict__ perm, int n, const Fields f,
                            int cta) {
  const int k = cta * kThreads + static_cast<int>(threadIdx.x);
  if (k >= n) return;
  const long long p = __ldg(perm + k);
  unsigned v[kMaxFields][kMaxWidth];
#pragma unroll
  for (int i = 0; i < kMaxFields; ++i) {
    if (i < f.count) {
      const int w = f.width[i];
      const unsigned* src = f.src[i] + p * w;
#pragma unroll
      for (int c = 0; c < kMaxWidth; ++c) {
        if (c < w) v[i][c] = __ldg(src + c);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxFields; ++i) {
    if (i < f.count) {
      const int w = f.width[i];
      unsigned* dst = f.dst[i] + static_cast<long long>(k) * w;
#pragma unroll
      for (int c = 0; c < kMaxWidth; ++c) {
        if (c < w) dst[c] = v[i][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rebuild_kernel(const int* __restrict__ ids, const long long* __restrict__ perm, int n,
               int num_cells, int* __restrict__ bounds, int items, int bound_ctas,
               const Fields f) {
  extern __shared__ __align__(16) int s_ids[];
  if (static_cast<int>(blockIdx.x) < bound_ctas) {
    bounds_tile(ids, n, num_cells, bounds, items, s_ids);
  } else {
    gather_rows(perm, n, f, static_cast<int>(blockIdx.x) - bound_ctas);
  }
}

}  // namespace

// items: merged positions (cells + ids) per bounds CTA, a multiple of 4.
// table: num_fields src pointers, then as many dst pointers, then their
// widths in words, as 64-bit integers; num_fields 0 launches no gather
// CTA (perm and table unread).
extern "C" int tisph_rebuild(const void* ids, const void* perm, int n, int num_cells,
                             void* bounds, int items, int num_fields, const long long* table,
                             void* stream) {
  if (num_fields < 0 || num_fields > kMaxFields || items < 4 || items % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fields f{};
  for (int i = 0; i < num_fields; ++i) {
    const long long width = table[2 * num_fields + i];
    if (width < 1 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
    f.src[i] = reinterpret_cast<const unsigned*>(table[i]);
    f.dst[i] = reinterpret_cast<unsigned*>(table[num_fields + i]);
    f.width[i] = static_cast<int>(width);
  }
  f.count = num_fields;
  const long long total = static_cast<long long>(n) + num_cells + 1;
  const int bound_ctas = static_cast<int>((total + items - 1) / items);
  const int gather_ctas = num_fields > 0 ? (n + kThreads - 1) / kThreads : 0;
  // the staged window, plus 3 ids of alignment below a0 and 3 past a1
  const size_t smem = static_cast<size_t>(items + 8) * sizeof(int);
  rebuild_kernel<<<bound_ctas + gather_ctas, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const long long*>(perm), n, num_cells,
      static_cast<int*>(bounds), items, bound_ctas, f);
  return static_cast<int>(cudaGetLastError());
}
