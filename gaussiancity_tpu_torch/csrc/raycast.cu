// Kernel V1: first-hit DDA raycast through an int32 id volume.
//
// Replaces the first-hit march of
// gaussiancity_tpu/ops/visibility.py::ray_voxel_intersection, which is an
// XLA while_loop (lockstep over all rays, bit-packed occupancy, a 1/4/16
// column hierarchy and survivor compaction) and has no Pallas kernel.
// Upstream ran the same traversal as CUDA
// (extensions/voxlib/ray_voxel_intersection.cu).
//
// Per ray: the ray is built from the shared basis (origin, up, side, fwd),
// the analytic sky skip applies (rays above ztop jump to ztop + 0.5;
// upward rays miss), then the DDA steps cell by cell: the next crossing is
// the smallest per-axis crossing parameter (lowest axis on ties), every
// crossing parameter is recomputed as (boundary - origin) / dir, and the
// first non-zero voxel entered is the hit.
//
// What a step touches: the occupancy tables of ops/visibility.py
// pack_occupancy (per-column z-words [h, w, dw], bit z % 32 of word
// z / 32; their OR over 4x4 column blocks; their OR over 16x16 blocks).
// The entered cell is tested against the 16x16 table in shared memory,
// then against the 4x4 table and the column's own word, each read from L2
// only when the ray enters another block, column or z-word and kept in a
// register while it stays there.  Where a 16x16 or 4x4 block is empty
// over a run of z around the cell, the ray jumps to the state in which the
// cell-by-cell walk leaves that region (jump_empty).  The id volume is
// read once per ray, at the hit.  The hit and the depth are those of the
// plain cell-by-cell walk (ops/visibility.py::raycast_plain), bit for bit.
//
// Layout: persistent blocks (as many as fit on the card at once), each
// loading the 16x16 table into shared memory once; every warp takes 8 x 4
// pixel tiles from a global counter, so that a warp's rays walk
// neighbouring columns and finish at similar steps, and a slow tile does
// not hold up a fixed share of the image.
//
// The per-ray state is held in scalars (an array indexed by the stepping
// axis would live in local memory), and the exit test compares the
// stepped cell with the first cell past the far face (the cell index moves
// by one a step, so this is the plain version's ">= size or < 0").
//
// COUNT builds a variant that also writes, per ray, the cells it stepped
// and the empty regions it jumped (a measurement of the design's work,
// raycast_work in ops/visibility.py); the frame's variant has no counting.
//
// What bounds it on an H100: the DDA's integer and fp32 operations, about
// 20 a step and 160 a jump; the bytes (the tables, the hit voxels, the
// output) are a few MB, mostly from L2.  Numerics: -fmad=false at build
// time and IEEE division / sqrt, so that the kernel and the plain version
// round alike.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int TILE_W = 4, TILE_H = 8;  // pixels of one warp's tile
constexpr unsigned FULL = 0xffffffffu;
// the 16x16 table stays in shared memory up to this size (bytes)
constexpr int MAX_SMEM_TABLE = 96 * 1024;

struct Tables {
  const int* vol;
  const unsigned* occ;      // [h, w, dw]
  const unsigned* coarse;   // [hb, wb, dw], 4x4 blocks
  const unsigned* coarse2;  // [hb2, wb2, dw], 16x16 blocks
  int h, w, d, dw, wb, wb2, n2;
};

struct View {
  const float* rays;  // origin, up, side, fwd
  int H, W;
  float cy, cx, f, ztop;
};

// the parameter at which a ray leaves cell c of an axis:
// (boundary - origin) / dir, as every step of the walk computes it
__device__ __forceinline__ float cross_t(int c, int b, float o, float inv) {
  return ((float)(c + b) - o) * inv;
}

// an axis leaving the cells [lo, hi]: the steps until the first cell past
// them (k) and the parameter of that crossing (t)
__device__ __forceinline__ void axis_exit(int c, int s, int b, float o,
                                          float inv, float r, int lo, int hi,
                                          int& k, float& t) {
  if (r == 0.0f) {
    k = 0x40000000;
    t = INFINITY;
    return;
  }
  const int past = s > 0 ? hi + 1 : lo - 1;
  k = (past - c) * s;
  t = cross_t(past - s, b, o, inv);
}

// how many of an axis's next k crossings the walk takes before the
// crossing (t_exit, exit axis): those with a smaller parameter, or an
// equal one on a lower axis (tie_first); the parameters never decrease
__device__ __forceinline__ int crossings_before(int c, int s, int b, float o,
                                                float inv, int k, float t_exit,
                                                bool tie_first) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float t = cross_t(c + s * mid, b, o, inv);
    if (t < t_exit || (tie_first && t == t_exit)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The cell just entered lies in a B x B block of columns whose z-word
// ``word`` (the OR of the block's columns) has no bit set from z_lo to
// z_hi around the cell: every cell of that region is empty.  Jump to the
// state in which the cell-by-cell walk takes its first crossing out of the
// region.  The walk takes crossings in order of (parameter, axis), and a
// crossing's parameter on one axis never decreases, so on each axis it has
// then taken exactly the crossings that come before the exit crossing.
template <int B>
__device__ __forceinline__ void jump_empty(
    unsigned word, int h, int w, int d, float r0, float r1, float r2, int s0,
    int s1, int s2, int b0, int b1, int b2, float o0, float o1, float o2,
    float i0, float i1, float i2, int& c0, int& c1, int& c2, float& t0,
    float& t1, float& t2) {
  const int zb = c2 & 31;
  const unsigned up = zb == 31 ? 0u : (word & (~0u << (zb + 1)));
  const unsigned down = word & ((1u << zb) - 1u);
  const int lo0 = c0 & ~(B - 1), lo1 = c1 & ~(B - 1);
  const int lo2 = (c2 & ~31) + (down ? 32 - __clz(down) : 0);
  const int hi0 = min(lo0 + B, h) - 1, hi1 = min(lo1 + B, w) - 1;
  const int hi2 = min((c2 & ~31) + (up ? __ffs(up) - 2 : 31), d - 1);
  int k0, k1, k2;
  float x0, x1, x2;
  axis_exit(c0, s0, b0, o0, i0, r0, lo0, hi0, k0, x0);
  axis_exit(c1, s1, b1, o1, i1, r1, lo1, hi1, k1, x1);
  axis_exit(c2, s2, b2, o2, i2, r2, lo2, hi2, k2, x2);
  const int ax = (x0 <= x1 && x0 <= x2) ? 0 : (x1 <= x2 ? 1 : 2);
  const float tx = ax == 0 ? x0 : (ax == 1 ? x1 : x2);
  // the exit axis takes all its crossings inside the region; on a tie with
  // the exit crossing a lower axis goes first
  if (r0 != 0.0f) {
    c0 += s0 * (ax == 0 ? k0 - 1
                        : crossings_before(c0, s0, b0, o0, i0, k0, tx, true));
    t0 = cross_t(c0, b0, o0, i0);
  }
  if (r1 != 0.0f) {
    c1 += s1 * (ax == 1 ? k1 - 1
                        : crossings_before(c1, s1, b1, o1, i1, k1, tx,
                                           ax > 1));
    t1 = cross_t(c1, b1, o1, i1);
  }
  if (r2 != 0.0f) {
    c2 += s2 * (ax == 2 ? k2 - 1
                        : crossings_before(c2, s2, b2, o2, i2, k2, tx, false));
    t2 = cross_t(c2, b2, o2, i2);
  }
}

template <bool SMEM, bool COUNT>
__global__ void __launch_bounds__(THREADS) raycast_kernel(
    Tables tb, View vw, int* __restrict__ voxel_id, float* __restrict__ depth,
    int* __restrict__ tile_counter, int* __restrict__ work) {
  extern __shared__ unsigned c2_smem[];
  const unsigned* c2s = tb.coarse2;
  if (SMEM) {
    for (int i = threadIdx.x; i < tb.n2; i += THREADS)
      c2_smem[i] = __ldg(tb.coarse2 + i);
    __syncthreads();
    c2s = c2_smem;
  }
  const int lane = threadIdx.x & 31;
  const int tiles_x = (vw.W + TILE_W - 1) / TILE_W;
  const int n_tiles = tiles_x * ((vw.H + TILE_H - 1) / TILE_H);
  const float* rays = vw.rays;
  const int h = tb.h, w = tb.w, d = tb.d, dw = tb.dw;

  while (true) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(tile_counter, 1);
    tile = __shfl_sync(FULL, tile, 0);
    if (tile >= n_tiles) break;
    const int px = (tile % tiles_x) * TILE_W + (lane % TILE_W);
    const int py = (tile / tiles_x) * TILE_H + (lane / TILE_W);
    if (px >= vw.W || py >= vw.H) continue;

    const float ndc0 = vw.cy - (float)py;
    const float ndc1 = (float)px - vw.cx;
    float r0 = rays[3] * ndc0 + rays[6] * ndc1 + rays[9] * vw.f;
    float r1 = rays[4] * ndc0 + rays[7] * ndc1 + rays[10] * vw.f;
    float r2 = rays[5] * ndc0 + rays[8] * ndc1 + rays[11] * vw.f;
    const float nrm = sqrtf(r0 * r0 + r1 * r1 + r2 * r2);
    r0 = r0 / nrm;
    r1 = r1 / nrm;
    r2 = r2 / nrm;

    int id = 0, n_step = 0, n_jump = 0;
    float dep = INFINITY;
    const float z_land = vw.ztop + 0.5f;
    const bool above = rays[2] > z_land;
    if (!(above && r2 >= 0.0f)) {
      float t_skip =
          (above && r2 < 0.0f) ? (z_land - rays[2]) / r2 : 0.0f;
      t_skip = fmaxf(t_skip, 0.0f);
      // per axis: origin, cell, step, 1 / dir, next crossing parameter
      // (boundary - origin) / dir, and the cell whose entry leaves the
      // volume (the first one past the far face)
      const float o0 = rays[0] + t_skip * r0;
      const float o1 = rays[1] + t_skip * r1;
      const float o2 = rays[2] + t_skip * r2;
      int c0 = (int)floorf(o0), c1 = (int)floorf(o1), c2 = (int)floorf(o2);
      const int b0 = r0 > 0.0f ? 1 : 0, b1 = r1 > 0.0f ? 1 : 0,
                b2 = r2 > 0.0f ? 1 : 0;
      const int s0 = b0 ? 1 : -1, s1 = b1 ? 1 : -1, s2 = b2 ? 1 : -1;
      const float i0 = 1.0f / r0, i1 = 1.0f / r1, i2 = 1.0f / r2;
      float t0 = r0 == 0.0f ? INFINITY : ((float)(c0 + b0) - o0) * i0;
      float t1 = r1 == 0.0f ? INFINITY : ((float)(c1 + b1) - o1) * i1;
      float t2 = r2 == 0.0f ? INFINITY : ((float)(c2 + b2) - o2) * i2;
      const int e0 = b0 ? max(h, c0 + 1) : min(-1, c0 - 1);
      const int e1 = b1 ? max(w, c1 + 1) : min(-1, c1 - 1);
      const int e2 = b2 ? max(d, c2 + 1) : min(-1, c2 - 1);
      int blk_at = -1, col_at = -1;  // table words held in registers
      unsigned blk_word = 0, col_word = 0;
      while (true) {
        // the next crossing: the smallest parameter, lowest axis on ties
        ++n_step;
        float t;
        if (t0 <= t1 && t0 <= t2) {
          t = t0;
          c0 += s0;
          if (c0 == e0) break;
          t0 = ((float)(c0 + b0) - o0) * i0;
        } else if (t1 <= t2) {
          t = t1;
          c1 += s1;
          if (c1 == e1) break;
          t1 = ((float)(c1 + b1) - o1) * i1;
        } else {
          t = t2;
          c2 += s2;
          if (c2 == e2) break;
          t2 = ((float)(c2 + b2) - o2) * i2;
        }
        if ((unsigned)c0 >= (unsigned)h || (unsigned)c1 >= (unsigned)w ||
            (unsigned)c2 >= (unsigned)d)
          continue;
        const int zw = c2 >> 5;
        const unsigned bit = 1u << (c2 & 31);
        const unsigned w16 = c2s[((c0 >> 4) * tb.wb2 + (c1 >> 4)) * dw + zw];
        if (!(w16 & bit)) {
          jump_empty<16>(w16, h, w, d, r0, r1, r2, s0, s1, s2, b0, b1, b2, o0,
                         o1, o2, i0, i1, i2, c0, c1, c2, t0, t1, t2);
          ++n_jump;
          continue;
        }
        const int bk = ((c0 >> 2) * tb.wb + (c1 >> 2)) * dw + zw;
        if (bk != blk_at) {
          blk_at = bk;
          blk_word = __ldg(tb.coarse + bk);
        }
        if (!(blk_word & bit)) {
          jump_empty<4>(blk_word, h, w, d, r0, r1, r2, s0, s1, s2, b0, b1, b2,
                        o0, o1, o2, i0, i1, i2, c0, c1, c2, t0, t1, t2);
          ++n_jump;
          continue;
        }
        const int ck = (c0 * w + c1) * dw + zw;
        if (ck != col_at) {
          col_at = ck;
          col_word = __ldg(tb.occ + ck);
        }
        if (!(col_word & bit)) continue;
        id = tb.vol[((size_t)c0 * w + c1) * d + c2];
        dep = t + t_skip;
        break;
      }
    }
    const int r = py * vw.W + px;
    voxel_id[r] = id;
    depth[r] = dep;
    if (COUNT) {
      work[2 * r] = n_step;
      work[2 * r + 1] = n_jump;
    }
  }
}

template <bool SMEM, bool COUNT>
int launch(const Tables& tb, const View& vw, int* voxel_id, float* depth,
           int* tile_counter, int* work, cudaStream_t stream) {
  const size_t smem = SMEM ? (size_t)tb.n2 * sizeof(unsigned) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raycast_kernel<SMEM, COUNT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, raycast_kernel<SMEM, COUNT>, THREADS, smem);
  const int warps = (vw.H * vw.W + 31) / 32;
  int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  blocks = min(blocks, (warps + THREADS / 32 - 1) / (THREADS / 32));
  if (blocks > 0)
    raycast_kernel<SMEM, COUNT><<<blocks, THREADS, smem, stream>>>(
        tb, vw, voxel_id, depth, tile_counter, work);
  return (int)cudaGetLastError();
}

}  // namespace

// tile_counter: one int32, 0 on entry (the warps' tile queue); work: null,
// or [H, W, 2] int32 for the steps each ray took and the empty regions it
// jumped (a measurement of the design's work)
extern "C" int raycast(const int* vol, const unsigned* occ,
                       const unsigned* coarse, const unsigned* coarse2, int h,
                       int w, int d, const float* rays, int H, int W,
                       float cy, float cx, float f, float ztop,
                       int* voxel_id, float* depth, int* tile_counter,
                       int* work, void* stream) {
  Tables tb;
  tb.vol = vol;
  tb.occ = occ;
  tb.coarse = coarse;
  tb.coarse2 = coarse2;
  tb.h = h;
  tb.w = w;
  tb.d = d;
  tb.dw = (d + 31) / 32;
  tb.wb = (w + 3) / 4;
  tb.wb2 = (tb.wb + 3) / 4;
  tb.n2 = ((h + 3) / 4 + 3) / 4 * tb.wb2 * tb.dw;
  View vw;
  vw.rays = rays;
  vw.H = H;
  vw.W = W;
  vw.cy = cy;
  vw.cx = cx;
  vw.f = f;
  vw.ztop = ztop;
  cudaStream_t s = (cudaStream_t)stream;
  const bool smem = (size_t)tb.n2 * sizeof(unsigned) <= (size_t)MAX_SMEM_TABLE;
  if (work == nullptr)
    return smem ? launch<true, false>(tb, vw, voxel_id, depth, tile_counter,
                                      work, s)
                : launch<false, false>(tb, vw, voxel_id, depth, tile_counter,
                                       work, s);
  return smem ? launch<true, true>(tb, vw, voxel_id, depth, tile_counter, work,
                                   s)
              : launch<false, true>(tb, vw, voxel_id, depth, tile_counter,
                                    work, s);
}

extern "C" const char* raycast_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
