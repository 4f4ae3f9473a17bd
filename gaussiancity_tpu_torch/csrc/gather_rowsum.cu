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
// Design: each thread takes IPT = 4 consecutive indices, read as one
// 16-byte int4 (a warp reads 512 contiguous bytes), clamps them, issues
// the four 16-byte row loads together, widens each value to float32
// exactly (the bf16 bits are the high half of the float32), sums
// k = 0..7 in order and writes the four sums as one float4.  The probe's
// 524,288 indices are then 512 blocks of 256 threads, one wave on 132 SMs.
// An index count that is not a multiple of 4, or an unaligned index or
// output pointer, takes the same path with scalar loads and stores.  An
// index outside [0, R) is clamped to the table, as a JAX gather clamps.
//
// What bounds it on an H100 (80GB HBM3, 700 W): L2.  The function needs
// 5.2 MB (the 1 MB table, the indices and the sums once each: 0.0016 ms),
// but each random 16-byte row costs a whole 32-byte L2 sector: 16.8 MB for
// the probe's 524,288 indices.  Timed from 65,536 to 4.2 M indices
// (chip_smoke.py), a call takes about 2.4 us (an empty kernel's
// launch-to-launch time is 2.0 us) plus 7.8 ps per index, about 4 TB/s of
// sectors from L2: 0.0066 ms at the probe's shape.  One index per thread
// (two waves of 2,048 blocks), four or eight per thread, and 128 or 512
// threads a block all measured the same; this design keeps the index and
// sum traffic in 16-byte accesses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int IPT = 4;  // indices per thread: one int4 and one float4

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

__device__ __forceinline__ float row_sum(uint4 row) {
  float s = bf16_lo(row.x);
  s = s + bf16_hi(row.x);
  s = s + bf16_lo(row.y);
  s = s + bf16_hi(row.y);
  s = s + bf16_lo(row.z);
  s = s + bf16_hi(row.z);
  s = s + bf16_lo(row.w);
  s = s + bf16_hi(row.w);
  return s;
}

__global__ void __launch_bounds__(BLOCK) gather_rowsum_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, int R,
    long long M, bool aligned, float* __restrict__ out) {
  const long long base =
      ((long long)blockIdx.x * BLOCK + threadIdx.x) * IPT;
  if (base >= M) return;
  const bool whole = aligned && base + IPT <= M;
  int r[IPT];
  if (whole) {
#pragma unroll
    for (int q = 0; q < IPT; q += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + base + q));
      r[q] = v.x;
      r[q + 1] = v.y;
      r[q + 2] = v.z;
      r[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < IPT; ++k) r[k] = base + k < M ? idx[base + k] : 0;
  }
  uint4 row[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int rk = r[k] < 0 ? 0 : (r[k] >= R ? R - 1 : r[k]);
    row[k] = __ldg(table + rk);
  }
  float s[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) s[k] = row_sum(row[k]);
  if (whole) {
#pragma unroll
    for (int q = 0; q < IPT; q += 4) {
      *reinterpret_cast<float4*>(out + base + q) =
          make_float4(s[q], s[q + 1], s[q + 2], s[q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      if (base + k < M) out[base + k] = s[k];
    }
  }
}

}  // namespace

extern "C" int gather_rowsum(const void* table, const int* idx, int R,
                             long long M, float* out, void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long per_block = (long long)BLOCK * IPT;
  const unsigned grid = (unsigned)((M + per_block - 1) / per_block);
  const bool aligned =
      ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0);
  gather_rowsum_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(table), idx, R, M, aligned, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_rowsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
