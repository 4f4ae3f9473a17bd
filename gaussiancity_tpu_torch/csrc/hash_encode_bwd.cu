// Kernel G1b: the multiresolution hash-grid backward, fused.
//
// Replaces the backward of gaussiancity_tpu/ops/hash_grid.py
// (_hash_encode_bwd, hash_grid.py:248-300), XLA code with no Pallas kernel
// of its own: it recomputes nothing (the JAX forward keeps the corner rows,
// weights and values), masks the gradient of out-of-bound points, feeds
// the embedding gradient to the sorted segment sum (kernel K3,
// csrc/segment_sum.cu) and takes the input gradient by the closed-form
// multilinear chain.  The port's forward (G1, csrc/hash_encode_fwd.cu)
// keeps only its inputs, so this kernel recomputes the geometry with G1's
// own code (hash_grid_common.cuh) and writes, in one launch:
//   - K3's inputs in the layout ops/hash_grid_bwd.py::hash_grad_embeddings
//     takes: keys [L, 2^D, N] int32 (level-local rows), weights
//     [L, 2^D, N] float32 and the masked gradient g_l [L, N, C] (0 for
//     out-of-bound points);
//   - where the inputs need a gradient, part [L, N, D]: per level, the sum
//     over the corners of <row, g[n, l, :]> * sign * product over d2 != d
//     of the corner's factor, times the level scale, over 2 * bound (0 for
//     out-of-bound points).  The wrapper sums part over the levels with one
//     deterministic torch.sum.
//
// Design: G1's block layout (one level and 32 points a block, two threads
// per corner row, levels in block order).  Each thread loads its half of
// the point's gradient row once and its corners' half rows 8 at a time;
// the two halves of <row, g> meet by one shuffle (low half first).  Of a
// row's two threads one writes the key and the other the weight, each a
// 64-byte line per warp.  The partial input gradients of a point's threads
// meet in shared memory and are added in lane order.
//
// Numerics: keys, weights and g_l are bit-equal to the plain version's
// (ops/hash_grid.py::hash_encode_bwd_plain); the input gradient's sums
// over channels, corners and levels run in another order, with fused
// multiply-adds.
//
// What bounds it on an H100 (80GB HBM3, 700 W): bytes and the gather.  It
// must write the keys and weights (67 MB at the REST train step: 16 levels
// x 32 corners x 16,384 points x 8 bytes) and g_l, read the inputs and the
// gradient and, for the input gradient, each distinct corner row once
// (220 MB in all: 0.066 ms); it takes about 0.13 ms, G1's gather (about
// 0.094 ms on the same points) plus the stores.  The chain's arithmetic
// (~60 operations per corner at D = 5) is below the fp32 peak.

#include "hash_grid_common.cuh"

namespace {

using namespace hash_grid;

template <int D, bool C8>
__global__ void __launch_bounds__(Layout<D, C8>::BLOCK)
    hash_encode_bwd_kernel(const float* __restrict__ inputs,
                           const float* __restrict__ table,
                           const int4* __restrict__ levels,
                           const float* __restrict__ g, int N, int L,
                           int R_max, int C, int chunks, float bound,
                           float two_bound, int* __restrict__ keys,
                           float* __restrict__ weights,
                           float* __restrict__ g_l,
                           float* __restrict__ part) {
  using Lay = Layout<D, C8>;
  constexpr int LANES = Lay::LANES, LOG = Lay::LOG_LANES, CH = Lay::CH;
  constexpr int NB = Lay::NB, NC = 1 << D;
  __shared__ Staged<D> s;
  __shared__ float red[LANES][POINTS][D + 1];
  const int l = blockIdx.x / chunks;
  const int n0 = (blockIdx.x % chunks) * POINTS;
  const Level lv = load_level(levels, l);
  stage_points<D>(s, inputs, n0, N, lv.scale, bound, two_bound);

  const bool emb = keys != nullptr, dx = part != nullptr;
  const int half = threadIdx.x % Lay::HALVES;
  const int p = (threadIdx.x / Lay::HALVES) % POINTS;
  const int lane = threadIdx.x / (Lay::HALVES * POINTS);
  const int n = n0 + p;
  // the two threads of a corner row: neighbouring lanes of one warp, on
  // the same point, so they take every branch below together
  const unsigned pair = 3u << ((threadIdx.x & 31) & ~1);
  float dfrac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dfrac[d] = 0.0f;
  if (n < N) {
    const bool gather = dx && !s.oob[p];
    Corners<D> q;
    load_corners<D, LOG>(s, p, lane, q);
    float gv[CH];
    if (gather) load_part<C8>(g + ((size_t)n * L + l) * C + half * CH, C, gv);
    const float* tab = table + (size_t)l * R_max * C + half * CH;
#pragma unroll
    for (int b = 0; b < Lay::CPL; b += NB) {
      float w[NB], v[NB][CH];
      long long row[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        corner<D, LOG>(q, b + j, lane, lv, w[j], row[j]);
        if (emb) {
          // one thread of the pair writes the key, the other the weight
          const size_t at = ((size_t)l * NC + (b + j) * LANES + lane) * N + n;
          if (half == 0) keys[at] = (int)row[j];
          if (half == Lay::HALVES - 1) weights[at] = w[j];
        }
      }
      if (!gather) continue;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        load_part<C8>(tab + (size_t)row[j] * C, C, v[j]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // <row, g[n, l, :]>: each thread's channels in order, then the
        // pair's two halves, low half first
        float dw = v[j][0] * gv[0];
#pragma unroll
        for (int k = 1; k < CH; ++k) dw = __fmaf_rn(v[j][k], gv[k], dw);
        if (C8) {
          const float other = __shfl_xor_sync(pair, dw, 1);
          dw = half == 0 ? dw + other : other + dw;
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float prod = 1.0f;
#pragma unroll
          for (int d2 = 0; d2 < D; ++d2) {
            if (d2 == d) continue;
            const int bit = corner_bit<LOG>(b + j, lane, d2);
            prod = prod * (bit ? q.f[1][d2] : q.f[0][d2]);
          }
          const int bit = corner_bit<LOG>(b + j, lane, d);
          dfrac[d] = __fmaf_rn(bit ? dw : -dw, prod, dfrac[d]);
        }
      }
    }
  }
  if (dx && half == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) red[lane][p][d] = dfrac[d];
  }
  __syncthreads();
  if (dx) {
    for (int e = threadIdx.x; e < POINTS * D; e += blockDim.x) {
      const int q = e / D, d = e % D;
      if (n0 + q >= N) continue;
      float sum = red[0][q][d];
#pragma unroll
      for (int k = 1; k < LANES; ++k) sum = sum + red[k][q][d];
      part[((size_t)l * N + n0 + q) * D + d] =
          s.oob[q] ? 0.0f : sum * lv.scale / two_bound;
    }
  }
  if (emb) {
    for (int e = threadIdx.x; e < POINTS * C; e += blockDim.x) {
      const int q = e / C, c = e % C;
      if (n0 + q >= N) continue;
      g_l[((size_t)l * N + n0 + q) * C + c] =
          s.oob[q] ? 0.0f : g[((size_t)(n0 + q) * L + l) * C + c];
    }
  }
}

template <int D>
cudaError_t launch_d(const float* inputs, const float* table,
                     const int4* levels, const float* g, int N, int L,
                     int R_max, int C, float bound, float two_bound,
                     int* keys, float* weights, float* g_l, float* part,
                     cudaStream_t stream) {
  const int chunks = (N + POINTS - 1) / POINTS;
  const unsigned grid = (unsigned)chunks * (unsigned)L;
  if (C == 8) {
    hash_encode_bwd_kernel<D, true><<<grid, Layout<D, true>::BLOCK, 0,
                                      stream>>>(
        inputs, table, levels, g, N, L, R_max, C, chunks, bound, two_bound,
        keys, weights, g_l, part);
  } else {
    hash_encode_bwd_kernel<D, false><<<grid, Layout<D, false>::BLOCK, 0,
                                       stream>>>(
        inputs, table, levels, g, N, L, R_max, C, chunks, bound, two_bound,
        keys, weights, g_l, part);
  }
  return cudaGetLastError();
}

}  // namespace

// keys, weights and g_l are all given or all null (no embedding
// gradient); part is null where the inputs need no gradient.
extern "C" int hash_encode_bwd(const float* inputs, const float* table,
                               const int* levels, const float* g, int N,
                               int D, int L, int R_max, int C, float bound,
                               float two_bound, int* keys, float* weights,
                               float* g_l, float* part, void* stream) {
  if (C < 1 || C > MAX_C || D < 1 || D > MAX_D) {
    return (int)cudaErrorInvalidValue;
  }
  if ((keys == nullptr) != (weights == nullptr)
      || (keys == nullptr) != (g_l == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0 || L == 0 || (keys == nullptr && part == nullptr)) return 0;
  if ((long long)((N + POINTS - 1) / POINTS) * L >= (1LL << 31)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int4* lv = reinterpret_cast<const int4*>(levels);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 1: return (int)launch_d<1>(inputs, table, lv, g, N, L, R_max, C,
                                    bound, two_bound, keys, weights, g_l,
                                    part, s);
    case 2: return (int)launch_d<2>(inputs, table, lv, g, N, L, R_max, C,
                                    bound, two_bound, keys, weights, g_l,
                                    part, s);
    case 3: return (int)launch_d<3>(inputs, table, lv, g, N, L, R_max, C,
                                    bound, two_bound, keys, weights, g_l,
                                    part, s);
    case 4: return (int)launch_d<4>(inputs, table, lv, g, N, L, R_max, C,
                                    bound, two_bound, keys, weights, g_l,
                                    part, s);
    case 5: return (int)launch_d<5>(inputs, table, lv, g, N, L, R_max, C,
                                    bound, two_bound, keys, weights, g_l,
                                    part, s);
    case 6: return (int)launch_d<6>(inputs, table, lv, g, N, L, R_max, C,
                                    bound, two_bound, keys, weights, g_l,
                                    part, s);
    default: return (int)launch_d<7>(inputs, table, lv, g, N, L, R_max, C,
                                     bound, two_bound, keys, weights, g_l,
                                     part, s);
  }
}

extern "C" const char* hash_encode_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
