// Kernel K3: deterministic duplicate-key segment sum of key-sorted rows.
//
// Replaces gaussiancity_tpu/ops/hash_grid_bwd.py::_bwd_kernel (launched
// there by scatter_rows_sorted), which reduces each table tile's sorted
// slice with a one-hot matmul on the MXU.  Two callers:
//   - the hash-grid embedding gradient (L levels, M corner updates per
//     level, C channels, R table rows per level);
//   - the rasterizer's per-Gaussian gradient reduction (L = 1, M slot
//     rows, C = 9, R = N Gaussians; dropped slots carry the key R).
//
// Input: keys [L, M] int32, ascending within each level, and the payload
// rows [L, M, C] float32 in the same (sorted) order.  Output: out [L, R, C]
// where out[l, r] is the sum of the rows whose key is r; rows that no key
// names are 0; keys outside [0, R) are dropped.
//
// Layout: parallel over the SORTED rows.  Each block owns a chunk of
// THREADS * rpt consecutive sorted rows of one level and the output rows
// [lo, hi) from its first key to the next chunk's first key (the first
// chunk from row 0, the last to row R).  The chunks' ranges tile [0, R),
// and a key's row belongs to the chunk that holds the last element of its
// run.  A block
//   1. loads its keys with the halo's keys before them and the next chunk's
//      first key, finds the positions whose keys lie in [0, R), and loads
//      only those rows into shared memory, row by row for an odd channel
//      count (16-byte copies), else channel-major with a skew of one word
//      per 32 rows (no bank conflicts below either way); a run that
//      began in an earlier chunk, at most a halo before, has its
//      earlier rows loaded with them.  Both loads are cp.async copies, all
//      of a thread's in flight at once;
//   2. sums each run from shared memory, every row read once: a run of at
//      most SHORT rows by the thread that holds its last row, a longer one
//      by a warp (rows strided over the lanes, a fixed shuffle tree);
//   3. adds, for a run that began more than a halo before the chunk,
//      the sum of its earlier rows, which the block reduces itself in a
//      fixed order after a 32-way search of one warp for the run's start;
//   4. writes every output row of [lo, hi) in windows of WINDOW rows: a
//      map from row to run end in shared memory, then the window's floats
//      in order with 16-byte stores, the sums and zeros for the rows that
//      no key names; where at most one row in 8 has a sum, zeros over the
//      whole window while the rows are still in flight, and at the end
//      each sum by its run's thread.
// Chunks whose range is empty (inside a run that goes on into the next
// chunk, or the per-Gaussian tail of dropped keys) exit after reading
// their keys.  No atomics and a fixed summing order: two runs give
// bit-equal results.
//
// What bounds it on an H100: bytes.  Each kept key and payload row is read
// once (a run that crosses a chunk edge is read again by its owner), and
// the dense output (268 MB for the REST hash grid) is written once, zeros
// included, so no separate memset pass is needed (a sparse window writes
// its few summed rows twice).  Arithmetic is one add per payload element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 16;
constexpr int MAX_RPT = 4;  // sorted rows per thread
constexpr int MAX_CHUNK = THREADS * MAX_RPT;
// positions held in shared memory: the chunk and a halo of SPAN - chunk
// positions before it (512 before a chunk of 128), so that a run that
// crosses into the chunk from at most that far back is found and summed
// without a search of global memory
constexpr int SPAN = MAX_CHUNK + THREADS;
// a run of at most SHORT rows (8 in chunks of 512) is summed by one
// thread, a longer one by a warp
constexpr int SHORT = 16;
constexpr int WINDOW = 1024;  // output rows per write window
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// shared-memory slot of chunk position i: one skew word per 32 positions,
// so that threads reading rows t * rpt + j (rpt in 1, 2, 4) hit 32 banks
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// asynchronous 4-byte copy global -> shared (no register staging, so a
// thread's copies are all in flight together)
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows_s[c * pitch + skew(p0 + g / C)] = src[g] for g in [0, nf), where
// g % C = c: the global reads coalesced, the shared slots channel-major
__device__ __forceinline__ void load_rows(float* __restrict__ rows_s,
                                          int pitch,
                                          const float* __restrict__ src,
                                          int p0, int nf, int C) {
  const int dq = THREADS / C, dr = THREADS % C;
  int i = threadIdx.x / C, c = threadIdx.x - i * C;
  for (int g = threadIdx.x; g < nf; g += THREADS) {
    copy_async(rows_s + c * pitch + skew(p0 + i), src + g);
    i += dq;
    c += dr;
    if (c >= C) {
      c -= C;
      ++i;
    }
  }
}

// dst[0, nf) = src[0, nf) into shared memory: 16-byte copies where the two
// share their alignment, 4-byte ones for the ragged ends
__device__ __forceinline__ void load_flat(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int nf) {
  int head = nf, nv = 0;
  if ((((uintptr_t)dst ^ (uintptr_t)src) & 15) == 0) {
    head = min(nf, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
    nv = (nf - head) >> 2;
  }
  for (int v = threadIdx.x; v < nv; v += THREADS) {
    const unsigned d =
        (unsigned)__cvta_generic_to_shared(dst + head + 4 * v);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + head + 4 * v)
                 : "memory");
  }
  for (int g = threadIdx.x; g < head; g += THREADS)
    copy_async(dst + g, src + g);
  for (int g = head + (nv << 2) + threadIdx.x; g < nf; g += THREADS)
    copy_async(dst + g, src + g);
}

// dst[0, nf) = 0 with 16-byte stores from the first 16-byte boundary on
__device__ __forceinline__ void store_zeros(float* __restrict__ dst, int nf) {
  const int head = min(nf, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2));
  const int nv = (nf - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int v = threadIdx.x; v < nv; v += THREADS)
    d4[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int g = threadIdx.x; g < head; g += THREADS) dst[g] = 0.0f;
  for (int g = head + (nv << 2) + threadIdx.x; g < nf; g += THREADS)
    dst[g] = 0.0f;
}

// CT: the channel count when fixed at compile time, 0 for any C <= MAX_C
template <int CT>
__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const int* __restrict__ keys, const float* __restrict__ rows, int M,
    int c_arg, int R, int rpt, int pitch, float* __restrict__ out) {
  constexpr int CC = CT ? CT : MAX_C;  // register rows of this many floats
  // an odd channel count keeps rows whole in shared memory (a warp reading
  // 32 rows of one channel hits 32 banks), which 16-byte copies can fill;
  // an even one keeps them channel by channel
  constexpr bool ROW_MAJOR = CT % 2 == 1;
  const int C = CT ? CT : c_arg;
  // keys of positions p in [-halo, n] around the chunk (rows m0 + p in
  // [0, M)), and rows of positions [-halo, n): [SPAN, C] row by row, or
  // [C, pitch] channel by channel
  extern __shared__ __align__(16) float rows_s[];
  __shared__ int keys_s[SPAN + 1 + (SPAN + 1) / 32];
  __shared__ int map_s[WINDOW];
  __shared__ int long_s[MAX_CHUNK];  // ends of runs longer than SHORT
  __shared__ float prior_s[WARPS][CC];
  __shared__ int pos_s[5];

  const int l = blockIdx.y;
  const int chunk = THREADS * rpt;
  const int halo = SPAN - chunk;
  const int m0 = blockIdx.x * chunk;
  const int n = min(chunk, M - m0);
  const int* k = keys + (size_t)l * M;
  const float* u = rows + (size_t)l * M * C;
  float* o = out + (size_t)l * R * C;
#define KEY(p) keys_s[skew((p) + halo)]
#define ROW(c, p)                                  \
  (ROW_MAJOR ? rows_s[((p) + halo) * C + (c)]      \
             : rows_s[(c) * pitch + skew((p) + halo)])

  // one round trip for the chunk's keys, the halo keys before it and the
  // next chunk's first key
  const int p_min = -min(halo, m0), p_max = min(n, M - m0 - 1);
  for (int p = p_min + (int)threadIdx.x; p <= p_max; p += THREADS)
    copy_async(&KEY(p), k + m0 + p);
  wait_copies();
  __syncthreads();
  // the output rows this chunk owns
  const int first = KEY(0);
  const int lo = blockIdx.x == 0 ? 0 : clampi(first, 0, R);
  const int hi = m0 + n == M ? R : clampi(KEY(n), 0, R);
  if (lo >= hi) return;
  // a kept run that began in an earlier chunk: this chunk owns its row
  // (its first key is lo < hi) and adds the sum of its earlier rows
  const bool crossing = m0 > 0 && KEY(-1) == first && first >= 0 &&
                        first < R;

  // kept positions [k0, k1): keys in [0, R) (a prefix of negative keys
  // and a suffix of keys >= R are dropped); the crossing run's start,
  // from the halo when it lies there
  if (threadIdx.x == 0) pos_s[4] = 0;
  for (int i = threadIdx.x; i <= n; i += THREADS) {
    const int prev = i == 0 ? 0 : KEY(i - 1);
    const int here = i == n ? 0 : KEY(i);
    if ((i == 0 || prev < 0) && (i == n || here >= 0)) pos_s[0] = i;
    if ((i == 0 || prev < R) && (i == n || here >= R)) pos_s[1] = i;
  }
  if (crossing) {
    for (int t = threadIdx.x; t < -p_min; t += THREADS) {
      const int p = -1 - t;
      if (KEY(p) == first && (p == p_min || KEY(p - 1) != first)) {
        // p_min = -m0 is row 0; otherwise the run begins before the halo
        pos_s[2] = m0 + p;
        pos_s[3] = p == p_min && m0 > halo;
      }
    }
  }
  __syncthreads();
  const int k0 = pos_s[0], k1 = pos_s[1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool longer = crossing && pos_s[3];
  if (longer) {
    // a run longer than the halo: a 32-way search of [0, m0 - halo] by
    // one warp; every row before the start has a smaller key
    if (warp == 0) {
      int lo_s = 0, hi_s = m0 - halo;
      while (true) {
        const int step = max(1, (hi_s - lo_s + 31) / 32);
        const int q = lo_s + lane * step;
        const bool less = q < hi_s && k[q] < first;
        const int cnt = __popc(__ballot_sync(FULL, less));
        if (step == 1 || cnt == 0) {
          lo_s += cnt;
          break;
        }
        const int q_last = lo_s + (cnt - 1) * step;
        hi_s = min(hi_s, q_last + step);
        lo_s = q_last + 1;
      }
      if (lane == 0) pos_s[2] = lo_s;
    }
    __syncthreads();
  }
  // the kept rows, and the crossing run's earlier ones in the halo
  const int p_lo = crossing && !longer ? pos_s[2] - m0 : k0;
  if (k1 > p_lo) {
    if (ROW_MAJOR) {
      load_flat(rows_s + (p_lo + halo) * C, u + (size_t)(m0 + p_lo) * C,
                (k1 - p_lo) * C);
    } else {
      load_rows(rows_s, pitch, u + (size_t)(m0 + p_lo) * C, p_lo + halo,
                (k1 - p_lo) * C, C);
    }
  }

  // while the rows are in flight: this thread's run ends (from the keys
  // alone), and zeros over the windows of [lo, hi) where at most one row
  // in 8 gets a sum (those rows are stored again below, after barriers)
  const int a = threadIdx.x * rpt;
  unsigned ends = 0;
  for (int j = 0; j < rpt; ++j) {
    const int i = a + j;
    if (i >= n) break;
    const int key = KEY(i);
    if (i >= k0 && i < k1 && (i + 1 < n ? KEY(i + 1) != key : key < hi))
      ends |= 1u << j;
  }
  unsigned sparse = 0;  // bit w: window w was zero-filled here
  for (int w = 0, w0 = lo; w0 < hi && w < 32; ++w, w0 += WINDOW) {
    const int nr = min(WINDOW, hi - w0);
    int mine = 0;
    for (int j = 0; j < rpt; ++j) {
      const int key = KEY(a + j);
      mine += ((ends >> j) & 1u) && key >= w0 && key < w0 + nr;
    }
    if (8 * __syncthreads_count(mine) <= nr) {
      store_zeros(o + (size_t)w0 * C, nr * C);
      sparse |= 1u << w;
    }
  }
  if (longer) {
    // the earlier rows, summed per thread in order, then over the lanes
    // and the warps in a fixed order
    float acc[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int i = pos_s[2] + threadIdx.x; i < m0; i += THREADS) {
      const float* row = u + (size_t)i * C;
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c < C) acc[c] = acc[c] + __ldg(row + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c < C) acc[c] = acc[c] + __shfl_down_sync(FULL, acc[c], off);
    }
#pragma unroll
    for (int c = 0; c < CC; ++c)
      if (c < C && lane == 0) prior_s[warp][c] = acc[c];
  }
  wait_copies();
  __syncthreads();  // rows_s, prior_s

  // each run's sum, written over its last row: a run of at most SHORT
  // rows (in shared memory) by the thread that holds its last row, a
  // longer one by a warp below; a run longer than the halo adds its
  // earlier rows' sum
  const int short_rows = rpt == MAX_RPT ? SHORT / 2 : SHORT;
  for (int j = 0; j < rpt; ++j) {
    if (!((ends >> j) & 1u)) continue;
    const int i = a + j;
    const int key = KEY(i);
    if (i - short_rows >= p_lo && KEY(i - short_rows) == key) {
      long_s[atomicAdd(&pos_s[4], 1)] = i;
      continue;
    }
    // the run's start: the keys before it, four read together at a time
    int p0 = i;
    for (int g = 0; g < short_rows; g += 4) {
      bool all = true;
#pragma unroll
      for (int d = 1; d <= 4; ++d) {
        const int q = i - g - d;
        const bool same = q >= p_lo && KEY(q) == key;
        all = all && same;
        if (all) p0 = q;
      }
      if (!all) break;
    }
    float sum[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) sum[c] = 0.0f;
    for (int p = p0; p <= i; ++p) {
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c < C) sum[c] = sum[c] + ROW(c, p);
    }
    if (longer && key == first) {
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        if (c < C) {
          float prior = 0.0f;
          for (int w2 = 0; w2 < WARPS; ++w2) prior = prior + prior_s[w2][c];
          sum[c] = prior + sum[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c)
      if (c < C) ROW(c, i) = sum[c];
  }
  __syncthreads();
  // the long runs, a warp each: the start by a 32-way search of the
  // keys (the run covers [start, i], start <= i - short_rows), the rows
  // strided over the lanes, a fixed shuffle tree
  const int n_long = pos_s[4];
  for (int q = warp; q < n_long; q += WARPS) {
    const int i = long_s[q];
    const int key = KEY(i);
    int b0 = p_lo, b1 = i - short_rows;  // start in [b0, b1]
    while (b0 < b1) {
      const int step = (b1 - b0 + 32) >> 5;
      const int at = b0 + lane * step;
      const int cnt = __popc(__ballot_sync(FULL, at < b1 && KEY(at) < key));
      if (cnt == 0) {
        b1 = b0;
      } else {
        const int last = b0 + (cnt - 1) * step;
        b1 = min(b1, last + step);
        b0 = last + 1;
      }
    }
    float sum[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) sum[c] = 0.0f;
    for (int p = b0 + lane; p <= i; p += 32) {
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c < C) sum[c] = sum[c] + ROW(c, p);
    }
    // levels outside, channels inside: a level's shuffles issue together
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c < C) sum[c] = sum[c] + __shfl_down_sync(FULL, sum[c], off);
    }
    if (longer && key == first) {
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        if (c < C) {
          float prior = 0.0f;
          for (int w2 = 0; w2 < WARPS; ++w2) prior = prior + prior_s[w2][c];
          sum[c] = prior + sum[c];
        }
      }
    }
    __syncwarp();  // every lane has read the run's last row
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c < C) ROW(c, i) = sum[c];
    }
  }
  __syncthreads();

  // write [lo, hi): the sums at their runs' rows, zeros elsewhere
  const int step_r = 4 * THREADS / C, step_c = 4 * THREADS % C;
  for (int w = 0, w0 = lo; w0 < hi; ++w, w0 += WINDOW) {
    const int nr = min(WINDOW, hi - w0);
    float* dst = o + (size_t)w0 * C;
    if (w < 32 && ((sparse >> w) & 1u)) {
      // zero-filled above: only the sums, over the zeros
      for (int j = 0; j < rpt; ++j) {
        if ((ends >> j) & 1u) {
          const int key = KEY(a + j);
          if (key >= w0 && key < w0 + nr) {
            float* d = dst + (size_t)(key - w0) * C;
#pragma unroll
            for (int c = 0; c < CC; ++c)
              if (c < C) d[c] = ROW(c, a + j);
          }
        }
      }
      continue;
    }
    int mine = 0;
    for (int j = 0; j < rpt; ++j) {
      if ((ends >> j) & 1u) {
        const int key = KEY(a + j);
        mine += key >= w0 && key < w0 + nr;
      }
    }
    if (!__syncthreads_or(mine)) {
      store_zeros(dst, nr * C);
      continue;
    }
    for (int r = threadIdx.x; r < nr; r += THREADS) map_s[r] = -1;
    __syncthreads();
    for (int j = 0; j < rpt; ++j) {
      if ((ends >> j) & 1u) {
        const int key = KEY(a + j);
        if (key >= w0 && key < w0 + nr) map_s[key - w0] = a + j;
      }
    }
    __syncthreads();
    // the window's floats in order, 16-byte stores from the first 16-byte
    // boundary on: neighbouring threads write neighbouring addresses
    const int nf = nr * C;
    const int head =
        min(nf, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2));
    const int nv = (nf - head) >> 2;
    for (int g = threadIdx.x; g < head; g += THREADS) {
      const int r = g / C, p = map_s[r];
      dst[g] = p >= 0 ? ROW(g - r * C, p) : 0.0f;
    }
    for (int g = head + (nv << 2) + threadIdx.x; g < nf; g += THREADS) {
      const int r = g / C, p = map_s[r];
      dst[g] = p >= 0 ? ROW(g - r * C, p) : 0.0f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    const int g0 = head + 4 * threadIdx.x;
    int r = g0 / C, c = g0 - r * C;
    for (int v = threadIdx.x; v < nv; v += THREADS) {
      float e[4];
      int re = r, ce = c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = map_s[re];
        e[q] = p >= 0 ? ROW(ce, p) : 0.0f;
        if (++ce == C) {
          ce = 0;
          ++re;
        }
      }
      d4[v] = make_float4(e[0], e[1], e[2], e[3]);
      r += step_r;
      c += step_c;
      if (c >= C) {
        c -= C;
        ++r;
      }
    }
    __syncthreads();
  }
#undef KEY
#undef ROW
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <int CT>
int launch(dim3 grid, size_t smem, cudaStream_t s, const int* keys,
           const float* rows, int M, int C, int R, int rpt, int pitch,
           float* out) {
  // static and dynamic shared memory above 48 KB (C > 9) must be allowed
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_sum_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  segment_sum_kernel<CT><<<grid, THREADS, smem, s>>>(keys, rows, M, C, R,
                                                     rpt, pitch, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum(const int* keys, const float* rows, int L, int M,
                           int C, int R, float* out, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  if (L == 0 || R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 0) {
    cudaMemsetAsync(out, 0, (size_t)L * R * C * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  // the largest chunk that still gives every SM several blocks
  int rpt = MAX_RPT;
  while (rpt > 1 &&
         (long long)L * ((M + THREADS * rpt - 1) / (THREADS * rpt)) <
             8LL * sm_count())
    rpt >>= 1;
  const int chunk = THREADS * rpt;
  // channel pitch: the skewed halo and chunk, rounded to 4 (mod 32) words,
  // so that neighbouring channels of one row land in different banks
  int pitch = SPAN + SPAN / 32;
  pitch += (36 - pitch % 32) % 32;
  const dim3 grid((unsigned)((M + chunk - 1) / chunk), (unsigned)L);
  const size_t smem = (size_t)C * pitch * sizeof(float);
  // the channel counts of the two callers (hash grid 8, per Gaussian 9)
  // get registers of their own size
  if (C == 8) return launch<8>(grid, smem, s, keys, rows, M, C, R, rpt, pitch,
                               out);
  if (C == 9) return launch<9>(grid, smem, s, keys, rows, M, C, R, rpt, pitch,
                               out);
  return launch<0>(grid, smem, s, keys, rows, M, C, R, rpt, pitch, out);
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
