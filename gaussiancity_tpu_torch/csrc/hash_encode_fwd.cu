// Kernel G1: the multiresolution hash-grid forward, fused.
//
// Replaces the forward gather of gaussiancity_tpu/ops/hash_grid.py
// (_hash_encode_fwd, hash_grid.py:229-245), which has no Pallas kernel: XLA
// gathers the 2^D corner rows of every point and level into [L, 2^D, N, C]
// and sums them weighted.  Its closest TPU kernel is the row-gather probe
// scripts/bench_gather3.py::kern (K4, csrc/gather_rowsum.cu).  Its backward
// is kernel G1b (csrc/hash_encode_bwd.cu); both share the geometry of
// hash_grid_common.cuh.
//
// Input: inputs [N, D] float32 in [-bound, bound]; the table [L, R_max, C]
// float32 (one row block per level, level-local row indices); per-level
// parameters [L, 4] int32: the level scale (float32 bits), the resolution,
// the hashed flag and the level's row count.  Output: out [N, L * C]
// float32, out[n, l*C + c] = sum over the 2^D corners of weight * row[c],
// 0 for points outside [-bound, bound]^D.
//
// Design (hash_grid_common.cuh): a block is one level and 32 points.  It
// stages its points' cells and fractions in shared memory (one division
// per (point, input)); each thread then takes its corners (16 at REST's
// D = 5 and C = 8, half of each corner row: two threads share a row),
// computes their weights and rows, issues 8 row loads at a time and adds
// weight * row into its sums with fused multiply-adds, in corner order.
// The partial sums of a point's threads meet in shared memory and are
// added in lane order, so the result is deterministic.  Blocks are
// numbered level by level, so the card works through about two levels'
// 16.8 MB row blocks at a time and L2 keeps them while their lookups run.
//
// Numerics: every corner's weight and row are bit-equal to the plain
// version's (ops/hash_grid.py::hash_encode_fwd_plain); the sum over the
// corners runs in another order and fuses each product into it.
//
// What bounds it on an H100 (80GB HBM3, 700 W): not the bytes the
// function needs but the rows it gathers.  At the REST train step (16,384
// uniform points: 8.4 M corner lookups, 4.2 M distinct rows) it takes
// about 0.094 ms against a bound of 0.043 ms (each distinct row once, as a
// 32-byte sector): the rows come from device memory as random 32-byte
// reads.  Numbered with the levels interleaved, the same blocks ran far
// slower: the level order is what lets L2 serve a row's second lookup.  On
// a frame's camera-view points the rows repeat (5.7 M lookups of 270 k
// distinct rows on the two-model frame's REST bucket) and sit in L2: there
// it takes about 5 ps per lookup (0.029 ms against 0.0056 ms), the path
// from L2 to the SMs for one 32-byte row per lookup.  Two threads per row
// (one line per row for each load instruction instead of two) ran faster
// than one on every use; looping a block over several chunks of points ran
// slower.

#include "hash_grid_common.cuh"

namespace {

using namespace hash_grid;

template <int D, bool C8>
__global__ void __launch_bounds__(Layout<D, C8>::BLOCK)
    hash_encode_fwd_kernel(const float* __restrict__ inputs,
                           const float* __restrict__ table,
                           const int4* __restrict__ levels, int N, int L,
                           int R_max, int C, int chunks, float bound,
                           float two_bound, float* __restrict__ out) {
  using Lay = Layout<D, C8>;
  constexpr int LANES = Lay::LANES, LOG = Lay::LOG_LANES, CH = Lay::CH;
  constexpr int NB = Lay::NB;
  __shared__ Staged<D> s;
  __shared__ float red[LANES][POINTS][Lay::CW + 1];
  const int l = blockIdx.x / chunks;
  const int n0 = (blockIdx.x % chunks) * POINTS;
  const Level lv = load_level(levels, l);
  stage_points<D>(s, inputs, n0, N, lv.scale, bound, two_bound);

  const int half = threadIdx.x % Lay::HALVES;
  const int p = (threadIdx.x / Lay::HALVES) % POINTS;
  const int lane = threadIdx.x / (Lay::HALVES * POINTS);
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  if (n0 + p < N && !s.oob[p]) {
    Corners<D> q;
    load_corners<D, LOG>(s, p, lane, q);
    const float* tab = table + (size_t)l * R_max * C + half * CH;
#pragma unroll
    for (int b = 0; b < Lay::CPL; b += NB) {
      float w[NB], v[NB][CH];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        long long row;
        corner<D, LOG>(q, b + j, lane, lv, w[j], row);
        load_part<C8>(tab + (size_t)row * C, C, v[j]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          acc[c] = __fmaf_rn(v[j][c], w[j], acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) red[lane][p][half * CH + c] = acc[c];
  __syncthreads();
  for (int e = threadIdx.x; e < POINTS * C; e += blockDim.x) {
    const int q = e / C, c = e % C;
    if (n0 + q >= N) continue;
    float sum = red[0][q][c];
#pragma unroll
    for (int k = 1; k < LANES; ++k) sum = sum + red[k][q][c];
    out[(size_t)(n0 + q) * L * C + (size_t)l * C + c] =
        s.oob[q] ? 0.0f : sum;
  }
}

template <int D>
cudaError_t launch_d(const float* inputs, const float* table,
                     const int4* levels, int N, int L, int R_max, int C,
                     float bound, float two_bound, float* out,
                     cudaStream_t stream) {
  const int chunks = (N + POINTS - 1) / POINTS;
  const unsigned grid = (unsigned)chunks * (unsigned)L;
  if (C == 8) {
    hash_encode_fwd_kernel<D, true><<<grid, Layout<D, true>::BLOCK, 0,
                                      stream>>>(
        inputs, table, levels, N, L, R_max, C, chunks, bound, two_bound,
        out);
  } else {
    hash_encode_fwd_kernel<D, false><<<grid, Layout<D, false>::BLOCK, 0,
                                       stream>>>(
        inputs, table, levels, N, L, R_max, C, chunks, bound, two_bound,
        out);
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
  if ((long long)((N + POINTS - 1) / POINTS) * L >= (1LL << 31)) {
    return (int)cudaErrorInvalidConfiguration;
  }
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
