// The hash-grid geometry shared by kernel G1 (hash_encode_fwd.cu, the
// forward) and kernel G1b (hash_encode_bwd.cu, its backward): the block
// layout, the staging of a block's points and each corner's weight and
// table row.  Both kernels compute them with the same float32 operations in
// the same order as the plain version (ops/hash_grid.py::_level_geometry),
// so every per-corner weight and row is bit-equal to it (-fmad=false):
//   x01 = (x + bound) / (2 bound)     IEEE division
//   pos = x01 * scale + 0.5           (align_corners=False)
//   cell = floor(pos), frac = pos - cell
//   w    = product over d = 0..D-1, in order, of (bit ? frac : 1 - frac)
//   row  = the uint32 XOR-prime hash (native wrap) or the dense stride in
//          64 bits, modulo the level's rows.
//
// Block layout (Layout below): one level and POINTS = 32 consecutive
// points in THREADS = 128 threads.  For 8 channels a corner row is loaded
// by two neighbouring threads of a warp, 16 bytes each, so that one load
// instruction of a warp names 16 rows and not 32 (the L1 looks up a line
// for each distinct row an instruction names); the 2^D corners of a point
// are split over LANES = 2 such pairs (4 lanes of one thread each for
// other channel counts), 16 corners a thread at REST's D = 5.  Lane k
// takes the corners j * LANES + k, so all its corners share their low bits
// and the product of their first log2(LANES) weight factors.  Blocks run
// level by level: block b is chunk b % chunks of level b / chunks, so the
// hardware's in-order dispatch works through about two levels' row blocks
// at a time.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hash_grid {

constexpr int MAX_D = 7;
constexpr int MAX_C = 16;
constexpr int POINTS = 32;
constexpr int THREADS = 128;
// corners a thread keeps loads in flight for at once: 8 half rows of 8
// channels, or 2 rows of up to 16
constexpr int BATCH = 8;
constexpr int BATCH_WIDE = 2;

template <int D, bool C8>
struct Layout {
  // threads per corner row, and the channels each holds
  static constexpr int HALVES = C8 ? 2 : 1;
  static constexpr int CH = C8 ? 4 : MAX_C;
  static constexpr int CORNERS = 1 << D;
  static constexpr int MAX_LANES = THREADS / (POINTS * HALVES);
  static constexpr int LANES = CORNERS < MAX_LANES ? CORNERS : MAX_LANES;
  static constexpr int LOG_LANES =
      LANES >= 8 ? 3 : (LANES >= 4 ? 2 : (LANES >= 2 ? 1 : 0));
  static constexpr int CPL = CORNERS / LANES;  // corners per thread
  static constexpr int NB =
      CPL < (C8 ? BATCH : BATCH_WIDE) ? CPL : (C8 ? BATCH : BATCH_WIDE);
  static constexpr int BLOCK = POINTS * LANES * HALVES;
  // width of a point's row of partial sums in shared memory
  static constexpr int CW = C8 ? 8 : MAX_C;
};

// grid_encoder_ext.cu:59-61
__constant__ unsigned PRIMES[MAX_D] = {1u, 2654435761u, 805459861u,
                                       3674653429u, 2097192037u,
                                       1434869437u, 2165219737u};

struct Level {
  float scale;
  long long stride1;  // resolution + 1
  bool hashed;
  long long rows;
  unsigned mask;  // rows - 1 where rows is a power of two, else 0
};

// per-level parameters [L, 4] int32: the scale's float32 bits, the
// resolution, the hashed flag and the level's row count
__device__ __forceinline__ Level load_level(const int4* levels, int l) {
  const int4 lp = levels[l];
  const unsigned rows = (unsigned)lp.w;
  return Level{__int_as_float(lp.x), (long long)lp.y + 1, lp.z != 0,
               (long long)lp.w, (rows & (rows - 1u)) ? 0u : rows - 1u};
}

// The block's points at one level, in shared memory: the cell and the
// fraction of each (point, input), and whether the point lies outside
// [-bound, bound]^D.
template <int D>
struct Staged {
  float frac[POINTS][D];
  int cell[POINTS][D];
  int outside[POINTS * D];  // per (point, input), folded into oob
  int oob[POINTS];
};

// (point i / D, input i % D) for i < POINTS * D from one coalesced read
// of the block's inputs; the block synchronises twice.
template <int D>
__device__ __forceinline__ void stage_points(
    Staged<D>& s, const float* __restrict__ inputs, int n0, int N,
    float scale, float bound, float two_bound) {
  for (int i = threadIdx.x; i < POINTS * D; i += blockDim.x) {
    const int p = i / D, d = i % D;
    int out = 0;
    if (n0 + p < N) {
      const float x01 = (inputs[(size_t)n0 * D + i] + bound) / two_bound;
      out = (x01 < 0.0f) || (x01 > 1.0f);
      const float pos = x01 * scale + 0.5f;
      const float g = floorf(pos);
      s.frac[p][d] = pos - g;
      s.cell[p][d] = (int)g;
    }
    s.outside[i] = out;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < POINTS; p += blockDim.x) {
    int out = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) out |= s.outside[p * D + d];
    s.oob[p] = out;
  }
  __syncthreads();
}

// One point's corner factors at one level, and the part of every corner's
// weight and hash that the thread's lane fixes (its low LOG_LANES bits).
template <int D>
struct Corners {
  float f[2][D];     // weight factor of bit 0 (1 - frac) and bit 1 (frac)
  unsigned h[2][D];  // hash term of bit 0 (cell * P) and bit 1
  int cell[D];
  float w_low;       // product of the factors of the low bits, in order
  unsigned h_low;
};

template <int D, int LOG_LANES>
__device__ __forceinline__ void load_corners(const Staged<D>& s, int p,
                                             int lane, Corners<D>& q) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float fr = s.frac[p][d];
    const int c = s.cell[p][d];
    q.f[0][d] = 1.0f - fr;
    q.f[1][d] = fr;
    q.h[0][d] = (unsigned)c * PRIMES[d];
    q.h[1][d] = (unsigned)(c + 1) * PRIMES[d];
    q.cell[d] = c;
  }
  q.w_low = 1.0f;
  q.h_low = 0u;
#pragma unroll
  for (int d = 0; d < LOG_LANES; ++d) {
    const int bit = (lane >> d) & 1;
    q.w_low = q.w_low * (bit ? q.f[1][d] : q.f[0][d]);
    q.h_low ^= bit ? q.h[1][d] : q.h[0][d];
  }
}

// Bit d of corner j * 2^LOG_LANES + lane.  In the kernels' unrolled loops
// j is a constant, so for d >= LOG_LANES the bit is one at compile time.
template <int LOG_LANES>
__device__ __forceinline__ int corner_bit(int j, int lane, int d) {
  return d < LOG_LANES ? (lane >> d) & 1 : (j >> (d - LOG_LANES)) & 1;
}

// Weight and level-local table row of corner j * 2^LOG_LANES + lane: the
// weight continues the low bits' product over d = LOG_LANES..D-1 in order.
template <int D, int LOG_LANES>
__device__ __forceinline__ void corner(const Corners<D>& q, int j, int lane,
                                       const Level& lv, float& w,
                                       long long& row) {
  w = q.w_low;
  unsigned h = q.h_low;
#pragma unroll
  for (int d = LOG_LANES; d < D; ++d) {
    const int bit = (j >> (d - LOG_LANES)) & 1;
    w = w * (bit ? q.f[1][d] : q.f[0][d]);
    h ^= bit ? q.h[1][d] : q.h[0][d];
  }
  if (lv.hashed) {
    // h mod rows: a mask for a power of two (every REST level), equal
    row = (long long)(lv.mask ? h & lv.mask : h % (unsigned)lv.rows);
  } else {
    long long lin = 0, stride = 1;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      lin += (long long)(q.cell[d] + corner_bit<LOG_LANES>(j, lane, d))
             * stride;
      stride *= lv.stride1;
    }
    row = lin % lv.rows;
    if (row < 0) row += lv.rows;
  }
}

// A thread's channels of a table row: for C = 8 one float4 (its half of
// the row; v points at that half), else C floats one at a time.
template <bool C8>
__device__ __forceinline__ void load_part(const float* v, int C,
                                          float (&r)[C8 ? 4 : MAX_C]) {
  if (C8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(v));
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) r[c] = c < C ? __ldg(v + c) : 0.0f;
  }
}

}  // namespace hash_grid
