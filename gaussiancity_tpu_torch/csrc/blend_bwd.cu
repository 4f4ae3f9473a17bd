// Kernel K2: tile-local alpha blending, backward.
//
// Replaces gaussiancity_tpu/ops/rasterizer/blend_pallas.py::_bwd_kernel
// (launched there by blend_tiles_pallas_bwd on the paged
// [T, K/page, 16, page] attributes that blend.py::_gather_pack
// materialises).  Same semantics as blend.py::_blend_bwd_impl and upstream
// renderCUDA backward (backward.cu:427-581): each pixel replays its slots
// back to front, k = k_hi - 1 .. 0, and a slot counts iff k < n_contrib,
// power <= 0, alpha >= alpha_min and (with the reference gate) the
// pixel's 16x16 sensor block lies in the slot's getRect bbox -- the
// forward's eligibility test, with no gating on the 0.99 alpha clamp.
// For a counted slot: T <- T / (1 - alpha), the accum_rec suffix colour
// recurrence, and the gradients of mx, my, ca, cb, cc, op, r, g, b.
//
// Output: the per-slot sums over the tile's pixels, compact: tile t's
// rows k < k_hi[t] at rows offsets[t] + k of grads, offsets the exclusive
// prefix sum of k_hi (tile_prep_kernel writes it); no other row is
// written.  The caller reduces the rows to per-Gaussian gradients (kernel
// K3, ops/rasterizer/blend.py::reduce_slot_grads).
//
// Layout: the front end of K1 (blend_common.cuh): one block of 128
// threads, two pixels each, per sub-tile, batches of 64 slots staged by
// cp.async under an mbarrier while
// the previous batch replays, culled for the sub-tile (the gate, and
// k < the sub-tile's largest n_contrib) and compacted with their original
// indices.  The sub-tile blocks of one tile form a thread block cluster
// (at most 8 blocks), and clusters are launched tiles with the most slots
// to replay first.  Sums, without atomics and in a fixed order:
//
// 1. a thread adds its two pixels' terms; a warp skips a slot that none
//    of its pixels counts (its sum is +0), otherwise it reduces the nine
//    values in 12 shuffles (warp_sum9: at each level lanes swap halves of
//    their vectors and add);
// 2. the block adds its warps' sums in warp order (the warps that counted
//    the slot, by a mask);
// 3. the cluster adds its blocks' batch rows in rank order, read from
//    distributed shared memory, and writes them.
//
// A fixed-order second pass over per-sub-tile rows in device memory would
// write and read the rows once more per sub-tile and needs a second
// launch; the cluster keeps them on chip.
//
// What bounds it on an H100: arithmetic, as for K1 (~26 operations up to
// the eligibility test, ~50 more per counted pair, the reductions); the
// bytes are the slot rows, four pixel planes and the live rows.
//
// Numerics: expf (not __expf), IEEE division, no fast math, and
// -fmad=false at build time, so that every pixel's terms equal those of
// the plain PyTorch version (ops/rasterizer/blend.py::blend_backward_plain)
// bit for bit; only the order of the sums over the pixels differs.

#include <cooperative_groups.h>

#include "blend_common.cuh"

namespace {

using namespace blend;
namespace cg = cooperative_groups;

constexpr int THREADS = 128;  // a sub-tile's block
constexpr int PX = 2;  // pixels of a thread
constexpr int N_WARPS = THREADS / 32;
constexpr int BATCH = 64;  // slots staged per batch
constexpr int N_GRAD = 9;
constexpr int MAX_CLUSTER = 8;  // portable cluster size

// Sum of v over the warp's lanes for one of the nine elements, in 12
// shuffles (the vector padded to 10, 6, 4 and 2 at the five levels).  On
// return elem is the element this lane holds, or -1 for a pad; lanes 2i
// and 2i + 1 hold the same one.
__device__ inline float warp_sum9(const float (&v)[N_GRAD], int lane,
                                  int& elem) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  float u[5], w[3], x[2];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const float lo = v[m], hi = m + 5 < N_GRAD ? v[m + 5] : 0.0f;
    u[m] = (h16 ? hi : lo) + __shfl_xor_sync(FULL, h16 ? lo : hi, 16);
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float lo = u[m], hi = m + 3 < 5 ? u[m + 3] : 0.0f;
    w[m] = (h8 ? hi : lo) + __shfl_xor_sync(FULL, h8 ? lo : hi, 8);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float lo = w[m], hi = m + 2 < 3 ? w[m + 2] : 0.0f;
    x[m] = (h4 ? hi : lo) + __shfl_xor_sync(FULL, h4 ? lo : hi, 4);
  }
  float y = (h2 ? x[1] : x[0]) + __shfl_xor_sync(FULL, h2 ? x[0] : x[1], 2);
  y = y + __shfl_xor_sync(FULL, y, 1);
  const int e3 = (h4 ? 2 : 0) + (h2 ? 1 : 0);
  const int e5 = (h8 ? 3 : 0) + e3;
  const int e = (h16 ? 5 : 0) + e5;
  elem = (e3 < 3 && e5 < 5 && e < N_GRAD) ? e : -1;
  return y;
}

__global__ void __launch_bounds__(THREADS) blend_bwd_kernel(
    const float* __restrict__ attrs, const int* __restrict__ gauss_index,
    const int* __restrict__ k_hi, Geom g, int ref_gate, float alpha_min,
    float alpha_max, const float* __restrict__ g_out,
    const float* __restrict__ bg_dot_g, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const int* __restrict__ order,
    const int* __restrict__ offsets, float* __restrict__ grads) {
  __shared__ __align__(16) Staging<BATCH> stg;
  __shared__ Ring<BATCH> ring;
  __shared__ float wpart[N_WARPS][BATCH][N_GRAD];
  __shared__ float bpart[BATCH * N_GRAD];
  __shared__ unsigned amask[BATCH];
  __shared__ int warp_n[N_WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int n_rank = g.n_sub;
  const int tile = order[blockIdx.x / n_rank];
  const SubTile<PX> s = locate<THREADS, PX>(g, tile, rank, tid);
  const bool gate_px = ref_gate && !s.one_block;
  staging_init<THREADS>(stg);

  // per-pixel state; pixels outside the image have no slot (nc = 0)
  float g0[PX], g1[PX], g2[PX], bgg[PX], fT[PX], T[PX];
  float ar0[PX], ar1[PX], ar2[PX], la[PX], lc0[PX], lc1[PX], lc2[PX];
  int nc[PX];
  int nc_thread = 0;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    g0[i] = g1[i] = g2[i] = bgg[i] = 0.0f;
    fT[i] = 1.0f;
    nc[i] = 0;
    if (s.p[i].inside) {
      const size_t hw = (size_t)g.img_h * g.img_w;
      const size_t p = (size_t)s.p[i].gy * g.img_w + s.p[i].gx;
      g0[i] = g_out[p];
      g1[i] = g_out[hw + p];
      g2[i] = g_out[2 * hw + p];
      bgg[i] = bg_dot_g[p];
      fT[i] = final_T[p];
      nc[i] = n_contrib[p];
    }
    T[i] = fT[i];
    ar0[i] = ar1[i] = ar2[i] = la[i] = lc0[i] = lc1[i] = lc2[i] = 0.0f;
    nc_thread = max(nc_thread, nc[i]);
  }
  // slots k >= the sub-tile's largest n_contrib count at none of its
  // pixels: they are not staged
  const unsigned nc_warp = __reduce_max_sync(FULL, (unsigned)nc_thread);
  if (lane == 0) warp_n[warp] = (int)nc_warp;
  __syncthreads();
  int nc_max = 0;
#pragma unroll
  for (int w = 0; w < N_WARPS; ++w) nc_max = max(nc_max, warp_n[w]);
  __syncthreads();

  const int khi = k_hi[tile];
  const int lim = min(khi, nc_max);
  const int* idx = gauss_index + (size_t)tile * g.K;
  float* out = grads + (size_t)offsets[tile] * N_GRAD;
  float2* my_row[2] = {tid < BATCH ? stg.row[0][tid] : nullptr,
                       tid < BATCH ? stg.row[1][tid] : nullptr};
  unsigned issued = 0, waited = 0;

  // batches back to front: [end - BATCH, end), end = khi, khi - BATCH, ..
  int start = max(khi - BATCH, 0);
  if (khi > 0) {
    const bool v = tid < khi - start && start + tid < lim;
    stage_row(my_row[0], attrs, v ? idx[start + tid] : 0, v, &stg.bar[0]);
    ++issued;
  }
  int nxt = max(start - BATCH, 0);
  bool v_next = tid < start - nxt && nxt + tid < lim;
  int gi_next = v_next ? idx[nxt + tid] : 0;
  for (int end = khi; end > 0; end = start, start = max(start - BATCH, 0)) {
    const int n = end - start;
    mbar_wait(&stg.bar[waited & 1], (waited >> 1) & 1);
    const float2* row = my_row[waited & 1];
    ++waited;
    for (int i = tid; i < n * N_GRAD; i += THREADS) bpart[i] = 0.0f;
    if (tid < BATCH) amask[tid] = 0u;
    int unused;
    const int n_kept =
        compact<THREADS>(row, tid < n && start + tid < lim, start + tid, s,
                         ref_gate, alpha_min, ring, warp_n, 0, unused);
    if (start > 0) {
      stage_row(my_row[issued & 1], attrs, gi_next, v_next,
                &stg.bar[issued & 1]);
      ++issued;
      const int after = max(nxt - BATCH, 0);
      v_next = tid < nxt - after && after + tid < lim;
      gi_next = v_next ? idx[after + tid] : 0;
      nxt = after;
    }

    for (int j = n_kept - 1; j >= 0; --j) {
      const float4 ga = ring.geo[j];
      const float4 gb = ring.aux[j];
      const int k1 = __float_as_int(gb.z);  // k + 1
      const float ca = ga.z, cb = ga.w, cc = gb.x;
      float dx[PX], dy[PX], G[PX], alpha[PX];
      bool ok[PX];
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        dx[i] = ga.x - s.p[i].px;
        dy[i] = ga.y - s.p[i].py;
        const float power =
            -0.5f * (ca * dx[i] * dx[i] + cc * dy[i] * dy[i]) -
            cb * dx[i] * dy[i];
        ok[i] = k1 <= nc[i] && power >= gb.y && power <= 0.0f;
        if (ok[i] && gate_px) {
          const float4 gt = ring.gate[j];
          ok[i] = s.p[i].bx16 >= gt.x && s.p[i].bx16 < gt.y &&
                  s.p[i].by16 >= gt.z && s.p[i].by16 < gt.w;
        }
        G[i] = ok[i] ? expf(power) : 0.0f;
      }
      const float4 cl = ok[0] || ok[1] ? ring.col[j]
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float op = cl.x, c0 = cl.y, c1 = cl.z, c2 = cl.w;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const float a = op * G[i];
        alpha[i] = a > alpha_max ? alpha_max : a;
        ok[i] = ok[i] && alpha[i] >= alpha_min;
      }
      if (!__any_sync(FULL, ok[0] || ok[1])) continue;
      float v[N_GRAD];
#pragma unroll
      for (int c = 0; c < N_GRAD; ++c) v[c] = 0.0f;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        if (!ok[i]) continue;
        const float one_m_alpha = 1.0f - alpha[i];
        T[i] = T[i] / one_m_alpha;  // T before this slot blended
        ar0[i] = la[i] * lc0[i] + (1.0f - la[i]) * ar0[i];
        ar1[i] = la[i] * lc1[i] + (1.0f - la[i]) * ar1[i];
        ar2[i] = la[i] * lc2[i] + (1.0f - la[i]) * ar2[i];
        const float w = alpha[i] * T[i];
        float dl_dalpha = T[i] * ((c0 - ar0[i]) * g0[i] +
                                  (c1 - ar1[i]) * g1[i] +
                                  (c2 - ar2[i]) * g2[i]);
        dl_dalpha = dl_dalpha - (fT[i] / one_m_alpha) * bgg[i];
        la[i] = alpha[i];
        lc0[i] = c0;
        lc1[i] = c1;
        lc2[i] = c2;
        const float dl_dG = op * dl_dalpha;
        const float gdx = G[i] * dx[i], gdy = G[i] * dy[i];
        // this pixel's terms, as the plain version computes them
        const float t[N_GRAD] = {dl_dG * (-gdx * ca - gdy * cb),
                                 dl_dG * (-gdy * cc - gdx * cb),
                                 -0.5f * gdx * dx[i] * dl_dG,
                                 -gdx * dy[i] * dl_dG,
                                 -0.5f * gdy * dy[i] * dl_dG,
                                 G[i] * dl_dalpha,
                                 w * g0[i],
                                 w * g1[i],
                                 w * g2[i]};
#pragma unroll
        for (int c = 0; c < N_GRAD; ++c) v[c] = v[c] + t[c];
      }
      int e;
      const float sum = warp_sum9(v, lane, e);
      if (e >= 0 && !(lane & 1)) wpart[warp][j][e] = sum;
      if (lane == 0) atomicOr(&amask[j], 1u << warp);
    }
    __syncthreads();
    // the block's rows: warps in order, then scattered to the batch's
    // slot positions (slots culled here stay 0)
    for (int i = tid; i < n_kept * N_GRAD; i += THREADS) {
      const int j = i / N_GRAD, c = i - j * N_GRAD;
      unsigned m = amask[j];
      float acc = 0.0f;
      while (m) {
        const int w = __ffs(m) - 1;
        m &= m - 1u;
        acc = acc + wpart[w][j][c];
      }
      bpart[(__float_as_int(ring.aux[j].z) - 1 - start) * N_GRAD + c] = acc;
    }
    cluster.sync();
    // the tile's rows: blocks in rank order, each rank writing a share
    const int n_el = n * N_GRAD;
    const int share = (n_el + n_rank - 1) / n_rank;
    const int lo = rank * share, hi = min(lo + share, n_el);
    for (int i = lo + tid; i < hi; i += THREADS) {
      float acc = 0.0f;
      for (int q = 0; q < n_rank; ++q)
        acc = acc + cluster.map_shared_rank(bpart, q)[i];
      out[(size_t)start * N_GRAD + i] = acc;
    }
    cluster.sync();
  }
}

}  // namespace

// scratch: 2T int32 (the tile order and the row offsets), written here
// before the replay.  grads: at least sum(k_hi) rows of 9 float32.
extern "C" int blend_bwd(const float* attrs, const int* gauss_index,
                         const int* k_hi, int T, int K, int n_tx, int tile_h,
                         int tile_w, int sub_h, int sub_w, int img_h,
                         int img_w, float origin_x, float origin_y,
                         int ref_gate, float alpha_min, float alpha_max,
                         const float* g_out, const float* bg_dot_g,
                         const float* final_T, const int* n_contrib,
                         int* scratch, float* grads, void* stream) {
  Geom g;
  const int bad = make_geom(g, T, K, n_tx, tile_h, tile_w, sub_h, sub_w,
                            img_h, img_w, origin_x, origin_y, MAX_CLUSTER);
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  int* order = scratch;
  int* offsets = scratch + T;
  tile_prep_kernel<<<1, PREP_THREADS, 0, s>>>(k_hi, T, K, order, offsets,
                                              nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || T == 0) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T * g.n_sub);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.n_sub;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, blend_bwd_kernel, attrs, gauss_index, k_hi, g,
                         ref_gate, alpha_min, alpha_max, g_out, bg_dot_g,
                         final_T, n_contrib, (const int*)order,
                         (const int*)offsets, grads);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* blend_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
