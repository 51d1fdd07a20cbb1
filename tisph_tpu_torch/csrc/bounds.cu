// CSR cell bounds over cell-sorted particle ids, for Hopper (sm_90a).
//
// Replaces tisph_tpu/ops/pallas/bounds.py::_bounds_kernel (the TPU's
// per-1024-cell compare-reduce).  Contract: ids[0..n) ascending, inactive
// tail = num_cells; writes bounds[c] = #(ids < c) = first k with
// ids[k] >= c, for c in [0, num_cells].
//
// Design: one thread per cell c, binary search over the sorted ids.  Every
// thread does the same ~log2(n) dependent loads, so no thread is long
// (the per-position boundary-marking form has one thread that fills the
// whole empty domain edge: ~380k of demo_3d's 475k cells), and neighbouring
// cells walk the same search path, so their loads coincide and stay in
// L1/L2 (the 780 KB id array of demo_3d fits in L2 many times over).  It is
// bound by the latency of those dependent loads; the writes are coalesced.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
csr_bounds_kernel(const int* __restrict__ ids, int n, int num_cells,
                  int* __restrict__ bounds) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c > num_cells) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  bounds[c] = lo;
}

}  // namespace

extern "C" int tisph_csr_bounds(const void* ids, int n, int num_cells,
                                void* bounds, void* stream) {
  const int total = num_cells + 1;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  csr_bounds_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), n, num_cells, static_cast<int*>(bounds));
  return static_cast<int>(cudaGetLastError());
}
