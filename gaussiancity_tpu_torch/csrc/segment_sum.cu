// Kernel K3: deterministic duplicate-key segment sum of key-sorted rows.
//
// Replaces gaussiancity_tpu/ops/hash_grid_bwd.py::_bwd_kernel (launched
// there by scatter_rows_sorted), which reduces each table tile's sorted
// slice with a one-hot matmul on the MXU.  Two callers:
//   - the hash-grid embedding gradient (L levels, M corner updates per
//     level, C channels, R table rows per level);
//   - the rasterizer's per-Gaussian gradient reduction (L = 1, M slot
//     rows, C = 9, R = N Gaussians).
//
// Input: keys [L, M] int32, ascending within each level, and the payload
// rows [L, M, C] float32 in the same (sorted) order.  Output: out [L, R, C]
// where out[l, r] is the sum of the rows whose key is r, taken in sorted
// order; rows that no key names are 0; keys outside [0, R) are dropped.
//
// Layout: one thread per output row, BLOCK rows per block.  Two threads of
// the block find the block's slice [m0, m1) of the sorted keys by binary
// search; every thread then binary-searches its own run inside that slice
// and sums it sequentially.  No atomics: every output element is written
// once by one thread, so two runs give bit-equal results.
//
// What bounds it on an H100: bytes.  Each key and payload row is read
// about once (a run is read by the thread that owns it; the binary
// searches touch the key slice, which stays in L1/L2), and the dense
// output (268 MB for the REST hash grid) is written once, zeros included,
// so no separate memset pass is needed.  Arithmetic is one add per
// payload element.  Long runs (coarse hash levels, where many corners
// share a row) serialise on their owning thread.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_C = 16;

// first position in [lo, hi) whose key is >= target
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int lo, int hi, long long target) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((long long)keys[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(BLOCK) segment_sum_kernel(
    const int* __restrict__ keys, const float* __restrict__ rows, int M,
    int C, int R, float* __restrict__ out) {
  __shared__ int bounds[2];
  const int l = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * BLOCK;
  const int* k = keys + (size_t)l * M;
  const float* u = rows + (size_t)l * M * C;
  if (threadIdx.x < 2) {
    bounds[threadIdx.x] = lower_bound(k, 0, M, r0 + threadIdx.x * BLOCK);
  }
  __syncthreads();
  const long long r = r0 + threadIdx.x;
  if (r >= R) return;
  const int s = lower_bound(k, bounds[0], bounds[1], r);
  const int e = lower_bound(k, s, bounds[1], r + 1);
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  for (int m = s; m < e; ++m) {
    const float* row = u + (size_t)m * C;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) acc[c] = acc[c] + row[c];
    }
  }
  float* o = out + ((size_t)l * R + r) * C;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) o[c] = acc[c];
  }
}

}  // namespace

extern "C" int segment_sum(const int* keys, const float* rows, int L, int M,
                           int C, int R, float* out, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  if (L == 0 || R == 0) return 0;
  const dim3 grid((unsigned)((R + BLOCK - 1) / BLOCK), (unsigned)L);
  segment_sum_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      keys, rows, M, C, R, out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
