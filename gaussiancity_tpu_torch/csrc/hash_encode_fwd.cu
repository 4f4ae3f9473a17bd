// Kernel G1: the multiresolution hash-grid forward, fused.
//
// Replaces the forward gather of gaussiancity_tpu/ops/hash_grid.py
// (_hash_encode_fwd, hash_grid.py:229-245), which has no Pallas kernel: XLA
// gathers the 2^D corner rows of every point and level into [L, 2^D, N, C]
// and sums them weighted.  Its closest TPU kernel is the row-gather probe
// scripts/bench_gather3.py::kern (K4, csrc/gather_rowsum.cu).
//
// Input: inputs [N, D] float32 in [-bound, bound]; the table [L, R_max, C]
// float32 (one row block per level, level-local row indices); per-level
// parameters [L, 4] int32: the level scale (float32 bits), the resolution,
// the hashed flag and the level's row count.  Output: out [N, L * C]
// float32, out[n, l*C + c] = sum over the 2^D corners of weight * row[c],
// 0 for points outside [-bound, bound]^D.
//
// Layout: one thread per (point, level), the level in blockIdx.y, so the
// blocks of one level run together and read only that level's 16.8 MB row
// block (REST: 2^19 rows x 8 channels), which the 50 MB L2 keeps.  Each
// thread computes its cell and weights once, walks the 2^D corners in
// corner order (bit d of the corner index is the offset along input d),
// loads each corner row (two float4 for C = 8) and sums weight * row in
// registers: the [2^D, N, C] intermediate is never written.
//
// Numerics: the same float32 operations in the same order as the plain
// version (ops/hash_grid.py::hash_encode_fwd_plain): x01 = (x + bound) /
// (2 bound) with IEEE division, pos = x01 * scale + 0.5 (no FMA: built with
// -fmad=false), floor, frac = pos - floor, the weight as the product over
// d = 0..D-1 in order; corner rows by the uint32 XOR-prime hash with native
// wrap or the dense stride in 64 bits, then modulo the level's rows.  So
// every per-corner term is bit-equal to the plain version's; only the
// order of the corner sum differs.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// dependent random row loads.  Each (point, level) reads 2^D rows of C
// floats scattered over the level's block: at least one 32-byte sector per
// corner row, N * L * 2^D * 32 bytes in all (268 MB for 16,384 points at
// REST's D = 5, L = 16), plus the inputs and the [N, L*C] output.  The
// arithmetic (~10 operations per corner and input) is far below the fp32
// peak.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_D = 7;
constexpr int MAX_C = 16;

// grid_encoder_ext.cu:59-61
__constant__ unsigned PRIMES[MAX_D] = {1u, 2654435761u, 805459861u,
                                       3674653429u, 2097192037u,
                                       1434869437u, 2165219737u};

template <int D, int C8>
__global__ void __launch_bounds__(BLOCK) hash_encode_fwd_kernel(
    const float* __restrict__ inputs, const float* __restrict__ table,
    const int4* __restrict__ levels, int N, int L, int R_max, int C,
    float bound, float two_bound, float* __restrict__ out) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  const int l = blockIdx.y;
  if (n >= N) return;
  const int4 lp = levels[l];
  const float scale = __int_as_float(lp.x);
  const long long stride1 = (long long)lp.y + 1;  // resolution + 1
  const bool hashed = lp.z != 0;
  const long long rows = lp.w;

  float frac[D];
  int cell[D];
  bool oob = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x01 = (inputs[(size_t)n * D + d] + bound) / two_bound;
    oob = oob || (x01 < 0.0f) || (x01 > 1.0f);
    const float pos = x01 * scale + 0.5f;
    const float g = floorf(pos);
    frac[d] = pos - g;
    cell[d] = (int)g;
  }

  float acc[C8 ? 8 : MAX_C];
#pragma unroll
  for (int c = 0; c < (C8 ? 8 : MAX_C); ++c) acc[c] = 0.0f;
  const float* tab = table + (size_t)l * R_max * C;
  for (int corner = 0; corner < (1 << D); ++corner) {
    float w = 1.0f;
    unsigned h = 0u;
    long long lin = 0, stride = 1;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = (corner >> d) & 1;
      w = w * (bit ? frac[d] : 1.0f - frac[d]);
      const int pc = cell[d] + bit;
      h ^= (unsigned)pc * PRIMES[d];
      lin += (long long)pc * stride;
      stride *= stride1;
    }
    long long row;
    if (hashed) {
      row = (long long)(h % (unsigned)rows);
    } else {
      row = lin % rows;
      if (row < 0) row += rows;
    }
    const float* v = tab + (size_t)row * C;
    if (C8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(v));
      const float4 b = __ldg(reinterpret_cast<const float4*>(v) + 1);
      acc[0] = acc[0] + a.x * w;
      acc[1] = acc[1] + a.y * w;
      acc[2] = acc[2] + a.z * w;
      acc[3] = acc[3] + a.w * w;
      acc[4] = acc[4] + b.x * w;
      acc[5] = acc[5] + b.y * w;
      acc[6] = acc[6] + b.z * w;
      acc[7] = acc[7] + b.w * w;
    } else {
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) acc[c] = acc[c] + __ldg(v + c) * w;
      }
    }
  }
  float* o = out + (size_t)n * L * C + (size_t)l * C;
  if (C8) {
    float4* o4 = reinterpret_cast<float4*>(o);
    o4[0] = oob ? make_float4(0.f, 0.f, 0.f, 0.f)
                : make_float4(acc[0], acc[1], acc[2], acc[3]);
    o4[1] = oob ? make_float4(0.f, 0.f, 0.f, 0.f)
                : make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) o[c] = oob ? 0.0f : acc[c];
    }
  }
}

template <int D>
cudaError_t launch_d(const float* inputs, const float* table,
                     const int4* levels, int N, int L, int R_max, int C,
                     float bound, float two_bound, float* out,
                     cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BLOCK - 1) / BLOCK), (unsigned)L);
  if (C == 8) {
    hash_encode_fwd_kernel<D, 1><<<grid, BLOCK, 0, stream>>>(
        inputs, table, levels, N, L, R_max, C, bound, two_bound, out);
  } else {
    hash_encode_fwd_kernel<D, 0><<<grid, BLOCK, 0, stream>>>(
        inputs, table, levels, N, L, R_max, C, bound, two_bound, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int hash_encode_fwd(const float* inputs, const float* table,
                               const int* levels, int N, int D, int L,
                               int R_max, int C, float bound, float two_bound,
                               float* out, void* stream) {
  if (C < 1 || C > MAX_C || D < 1 || D > MAX_D) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0 || L == 0) return 0;
  const int4* lv = reinterpret_cast<const int4*>(levels);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 1: return (int)launch_d<1>(inputs, table, lv, N, L, R_max, C, bound,
                                    two_bound, out, s);
    case 2: return (int)launch_d<2>(inputs, table, lv, N, L, R_max, C, bound,
                                    two_bound, out, s);
    case 3: return (int)launch_d<3>(inputs, table, lv, N, L, R_max, C, bound,
                                    two_bound, out, s);
    case 4: return (int)launch_d<4>(inputs, table, lv, N, L, R_max, C, bound,
                                    two_bound, out, s);
    case 5: return (int)launch_d<5>(inputs, table, lv, N, L, R_max, C, bound,
                                    two_bound, out, s);
    case 6: return (int)launch_d<6>(inputs, table, lv, N, L, R_max, C, bound,
                                    two_bound, out, s);
    default: return (int)launch_d<7>(inputs, table, lv, N, L, R_max, C,
                                     bound, two_bound, out, s);
  }
}

extern "C" const char* hash_encode_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
