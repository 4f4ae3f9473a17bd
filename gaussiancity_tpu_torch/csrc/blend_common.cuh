// Shared front end of kernels K1 (blend_fwd.cu) and K2 (blend_bwd.cu).
//
// Work unit: a sub-tile of at most 256 pixels
// (ops/rasterizer/blend.py::sub_tile_shape: 16x16 of a 32x32 tile, 8x32 of
// an 8x128 tile) on one block: K1 256 threads of one pixel, K2 128 threads
// of two pixels (whose slot loads from the ring, loop and warp reduction
// are then shared).  Every sub-tile of a tile walks the tile's slot list.
//
// Staging: each batch's slot rows are copied from attrs[N, 10] through
// gauss_index into shared memory by cp.async copies that an mbarrier
// tracks, so that the next batch's gather is in flight while the current
// batch is blended.  The batch is then culled for the sub-tile and
// compacted, in slot order, into a ring of kept slots that carries each
// slot's original index (as k + 1, the n_contrib of a blend there):
//
// - the cull: with the reference gate, a slot whose getRect 16x16-block
//   range (the float expressions of blend.py::_gate_rect) misses every
//   16x16 sensor block of the sub-tile's in-image pixels fails the
//   per-pixel gate at each of them, so dropping it is exact;
// - the alpha floor: below power = log(alpha_min / op) - 2^-10 (computed
//   once per kept slot) op * expf(power) < alpha_min for every rounding of
//   logf (1 ulp), expf (2 ulp) and the products (0.5 ulp), so a pixel
//   skips expf and the rest of the slot there.  Both are predicates only:
//   every pixel still runs the exact tests of the plain version (the
//   gate's in the cull itself where the sub-tile lies in one block).
//
// tile_prep_kernel orders the tiles by their slot counts, largest first
// (the work units' order), and writes the exclusive prefix sum of the
// counts (K2's row offsets).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace blend {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SUB_PIXELS = 256;  // pixels of a sub-tile, at most
constexpr int ATTR_COLS = 10;  // mx my ca cb cc op r g b radius
constexpr int ROW_PAIRS = ATTR_COLS / 2;  // a row as 8-byte copies
constexpr int PREP_THREADS = 1024;
constexpr float POWER_MARGIN = 0.0009765625f;  // 2^-10

struct Geom {
  int T, K, n_tx, tile_h, tile_w, sub_h, sub_w, n_sx, n_sub, img_h, img_w;
  float origin_x, origin_y;
};

// Checks the launcher's geometry (sub-tiles of at most SUB_PIXELS, at most
// max_sub of them a tile); 0 or cudaErrorInvalidValue.
inline int make_geom(Geom& g, int T, int K, int n_tx, int tile_h,
                     int tile_w, int sub_h, int sub_w, int img_h, int img_w,
                     float origin_x, float origin_y, int max_sub) {
  if (T < 0 || K < 0 || n_tx <= 0 || tile_h <= 0 || tile_w <= 0 ||
      sub_h <= 0 || sub_w <= 0 || sub_h > tile_h || sub_w > tile_w ||
      sub_h * sub_w > SUB_PIXELS || (long long)T * K >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  g.T = T;
  g.K = K;
  g.n_tx = n_tx;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.sub_h = sub_h;
  g.sub_w = sub_w;
  g.n_sx = (tile_w + sub_w - 1) / sub_w;
  g.n_sub = g.n_sx * ((tile_h + sub_h - 1) / sub_h);
  g.img_h = img_h;
  g.img_w = img_w;
  g.origin_x = origin_x;
  g.origin_y = origin_y;
  return g.n_sub > max_sub ? (int)cudaErrorInvalidValue : 0;
}

struct Pixel {
  int gx, gy;
  bool inside;  // the pixel lies in the tile and in the image
  float px, py, bx16, by16;
};

// One thread's PX pixels of a sub-tile, and the sub-tile's 16x16-block
// range.
template <int PX>
struct SubTile {
  Pixel p[PX];
  bool empty;  // the sub-tile has no in-image pixel
  float bxl, bxh, byl, byh;  // block range of its in-image pixels
  // the sub-tile lies in one 16x16 block: the cull's test is then the
  // per-pixel gate of every pixel, which need not run again
  bool one_block;
};

// Thread tid of NT, each with PX pixels (NT * PX >= SUB_PIXELS).
template <int NT, int PX>
__device__ inline SubTile<PX> locate(const Geom& g, int tile, int sub,
                                     int tid) {
  static_assert(NT * PX >= SUB_PIXELS, "a block must cover a sub-tile");
  SubTile<PX> s;
  const int tx = tile % g.n_tx, ty = tile / g.n_tx;
  const int sx0 = (sub % g.n_sx) * g.sub_w, sy0 = (sub / g.n_sx) * g.sub_h;
  const int sx1 = min(min(sx0 + g.sub_w, g.tile_w), g.img_w - tx * g.tile_w);
  const int sy1 = min(min(sy0 + g.sub_h, g.tile_h), g.img_h - ty * g.tile_h);
  // window renders shift the pixel origin (sensor coords), not the means
  const float x0 = (float)(tx * g.tile_w) + g.origin_x;
  const float y0 = (float)(ty * g.tile_h) + g.origin_y;
  // where the sub-tile splits into PX bands of rows made of 8 x 4 pixel
  // blocks, a warp takes one such block in each band (fewer warps per
  // small Gaussian than a 32 x 1 row); else pixels tid + i * NT in
  // row-major order
  const bool blocks8x4 = g.sub_w % 8 == 0 && g.sub_h % (4 * PX) == 0;
  const int warp = tid >> 5, lane = tid & 31, per_row = max(g.sub_w / 8, 1);
  const int band = g.sub_h / PX;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    int lx, ly;
    bool valid;
    if (blocks8x4) {
      lx = (warp % per_row) * 8 + (lane & 7);
      ly = (warp / per_row) * 4 + (lane >> 3);
      valid = ly < band;
      ly += i * band;
    } else {
      const int q = tid + i * NT;
      lx = q % g.sub_w;
      ly = q / g.sub_w;
      valid = q < g.sub_w * g.sub_h;
    }
    const int ix = sx0 + lx, iy = sy0 + ly;
    Pixel& p = s.p[i];
    p.inside = valid && ix < sx1 && iy < sy1;
    p.gx = tx * g.tile_w + ix;
    p.gy = ty * g.tile_h + iy;
    p.px = x0 + (float)ix;
    p.py = y0 + (float)iy;
    p.bx16 = floorf(p.px * 0.0625f);
    p.by16 = floorf(p.py * 0.0625f);
  }
  s.empty = sx1 <= sx0 || sy1 <= sy0;
  s.bxl = floorf((x0 + (float)sx0) * 0.0625f);
  s.bxh = floorf((x0 + (float)(sx1 - 1)) * 0.0625f);
  s.byl = floorf((y0 + (float)sy0) * 0.0625f);
  s.byh = floorf((y0 + (float)(sy1 - 1)) * 0.0625f);
  s.one_block = s.bxl == s.bxh && s.byl == s.byh;
  return s;
}

// ---- staging: cp.async copies tracked by an mbarrier -------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copies attrs row g (40 bytes, 8-byte aligned) into row when valid; every
// thread of the block then arrives on bar once its copies have landed (the
// barrier counts the block's threads).
__device__ inline void stage_row(float2* row, const float* __restrict__ attrs,
                                 int g, bool valid, uint64_t* bar) {
  if (valid) {
    const float2* src =
        reinterpret_cast<const float2*>(attrs + (size_t)g * ATTR_COLS);
#pragma unroll
    for (int i = 0; i < ROW_PAIRS; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_u32(row + i)),
                   "l"(src + i)
                   : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Double-buffered staging rows and their mbarriers.  Batch n of the block
// (over all its work units) lands in buffer n & 1, whose barrier then
// completes its (n >> 1)-th phase.
template <int BATCH>
struct Staging {
  float2 row[2][BATCH][ROW_PAIRS];
  uint64_t bar[2];
};

template <int NT, int BATCH>
__device__ inline void staging_init(Staging<BATCH>& st) {
  if (threadIdx.x == 0) {
    mbar_init(&st.bar[0], NT);
    mbar_init(&st.bar[1], NT);
    mbar_init_fence();
  }
  __syncthreads();
}

// ---- cull and compaction -----------------------------------------------

// Kept slots of one batch, in slot order.
template <int BATCH>
struct Ring {
  float4 geo[BATCH];   // mx my ca cb
  float4 aux[BATCH];   // cc, alpha-floor power, k + 1 (int bits), 0
  float4 col[BATCH];   // op r g b
  float4 gate[BATCH];  // getRect 16x16 blocks: xlo xhi ylo yhi
};

__device__ inline float alpha_floor_power(float op, float alpha_min) {
  if (!(alpha_min > 0.0f)) return -INFINITY;
  if (!(op > 0.0f)) return INFINITY;  // alpha <= 0 < alpha_min
  return logf(alpha_min / op) - POWER_MARGIN;
}

// Culls the batch's staged rows for the sub-tile and writes the kept ones
// into the ring in slot order.  Thread j holds slot k = first + j (row,
// when valid).  Returns the number kept; n_flag receives the block's count
// of flag (taken at the first barrier, after the previous batch's blend).
template <int NT, int BATCH, int PX>
__device__ inline int compact(const float2* row, bool valid, int k,
                              const SubTile<PX>& s, int ref_gate,
                              float alpha_min, Ring<BATCH>& ring, int* warp_n,
                              int flag, int& n_flag) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float a[ATTR_COLS];
  float xlo = 0.0f, xhi = 0.0f, ylo = 0.0f, yhi = 0.0f;
  bool keep = false;
  if (valid) {
#pragma unroll
    for (int i = 0; i < ROW_PAIRS; ++i) {
      const float2 t = row[i];
      a[2 * i] = t.x;
      a[2 * i + 1] = t.y;
    }
    const float mx = a[0], my = a[1], rd = a[9];
    xlo = floorf((mx - rd) * 0.0625f);
    xhi = floorf((mx + rd + 15.0f) * 0.0625f);
    ylo = floorf((my - rd) * 0.0625f);
    yhi = floorf((my + rd + 15.0f) * 0.0625f);
    keep = !ref_gate || (xlo <= s.bxh && xhi > s.bxl && ylo <= s.byh &&
                         yhi > s.byl);
  }
  const unsigned m = __ballot_sync(FULL, keep);
  if (lane == 0) warp_n[warp] = __popc(m);
  n_flag = __syncthreads_count(flag);
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int c = warp_n[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (keep) {
    const int pos = before + __popc(m & ((1u << lane) - 1u));
    ring.geo[pos] = make_float4(a[0], a[1], a[2], a[3]);
    ring.aux[pos] = make_float4(a[4], alpha_floor_power(a[5], alpha_min),
                                __int_as_float(k + 1), 0.0f);
    ring.col[pos] = make_float4(a[5], a[6], a[7], a[8]);
    ring.gate[pos] = make_float4(xlo, xhi, ylo, yhi);
  }
  __syncthreads();
  return total;
}

// ---- tile order and row offsets ----------------------------------------

// Exclusive prefix sum over the block (PREP_THREADS threads); total gets
// the block's sum.
__device__ inline int block_excl_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = PREP_THREADS / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    __syncwarp();
    wsum[lane] = s;
  }
  __syncthreads();
  total = wsum[nw - 1];
  const int excl = x - v + (warp > 0 ? wsum[warp - 1] : 0);
  __syncthreads();
  return excl;
}

// One block of PREP_THREADS: order[T] lists the tiles by key, largest
// first (a counting sort over PREP_THREADS buckets of keys in
// [0, key_max]; the order within a bucket is arbitrary and changes no
// result); offsets (optional) gets the exclusive prefix sum of the keys in
// tile order; counter (optional) is set to 0.
__global__ void __launch_bounds__(PREP_THREADS)
    tile_prep_kernel(const int* __restrict__ keys, int T, int key_max,
                     int* __restrict__ order, int* __restrict__ offsets,
                     int* __restrict__ counter) {
  __shared__ int hist[PREP_THREADS];
  __shared__ int wsum[32];
  const int tid = threadIdx.x;
  const int width = key_max / PREP_THREADS + 1;
  auto bucket = [&](int key) {
    return PREP_THREADS - 1 - min(max(key, 0), key_max) / width;
  };
  hist[tid] = 0;
  __syncthreads();
  for (int t = tid; t < T; t += PREP_THREADS)
    atomicAdd(&hist[bucket(keys[t])], 1);
  __syncthreads();
  int total;
  const int start = block_excl_scan(hist[tid], wsum, total);
  hist[tid] = start;
  __syncthreads();
  for (int t = tid; t < T; t += PREP_THREADS)
    order[atomicAdd(&hist[bucket(keys[t])], 1)] = t;
  if (offsets != nullptr) {
    int carry = 0;
    for (int base = 0; base < T; base += PREP_THREADS) {
      const int t = base + tid;
      const int excl = block_excl_scan(t < T ? keys[t] : 0, wsum, total);
      if (t < T) offsets[t] = carry + excl;
      carry += total;
    }
  }
  if (counter != nullptr && tid == 0) *counter = 0;
}

}  // namespace blend
