// Kernel K4: a row gather from a small bf16 table, each row summed over its
// channels.
//
// Replaces scripts/bench_gather3.py::kern (the Pallas call at
// bench_gather3.py:75), the JAX package's probe of a VMEM-resident row
// gather for the hash grid: a bf16 table [R, 8] and int32 indices
// [8, U / 8] give out[i, j] = sum_k float(tab[idx[i, j], k]).  Its
// counterpart in the system is the hash-grid forward gather, G1
// (csrc/hash_encode_fwd.cu).
//
// Layout: one thread per index.  It reads one 16-byte row (8 bf16 as one
// uint4), widens each value to float32 exactly (the bf16 bits are the high
// half of the float32), and sums k = 0..7 in order.  An index outside
// [0, R) is clamped to the table, as a JAX gather clamps.
//
// What bounds it on an H100: bytes.  The table (1 MB at the probe's
// 65,536 rows) is read through L2, the indices and the float32 sums once
// each; 15 operations per index are far below any compute peak.  Indices
// are read and sums written coalesced, 4 bytes per thread; the row loads
// are random 16-byte reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

__global__ void __launch_bounds__(BLOCK) gather_rowsum_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, int R,
    long long M, float* __restrict__ out) {
  const long long m = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (m >= M) return;
  int r = idx[m];
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  const uint4 row = __ldg(table + r);
  float s = bf16_lo(row.x);
  s = s + bf16_hi(row.x);
  s = s + bf16_lo(row.y);
  s = s + bf16_hi(row.y);
  s = s + bf16_lo(row.z);
  s = s + bf16_hi(row.z);
  s = s + bf16_lo(row.w);
  s = s + bf16_hi(row.w);
  out[m] = s;
}

}  // namespace

extern "C" int gather_rowsum(const void* table, const int* idx, int R,
                             long long M, float* out, void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const unsigned grid = (unsigned)((M + BLOCK - 1) / BLOCK);
  gather_rowsum_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(table), idx, R, M, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_rowsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
