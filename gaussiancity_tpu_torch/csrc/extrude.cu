// Kernel E1: footprint extrusion, projection maps -> shell voxel rows.
//
// Replaces gaussiancity_tpu/ops/extrusion.py:83-181 (the XLA
// ``extrude_dense`` + ``extrude_points``, no Pallas kernel; upstream
// footprint_extruder.cpp:100-222 and voxlib maps_to_volume.cu).  Each
// masked pixel (i, j) walks its column k = BU, BU+s, ..., <= TD at its
// class scale s and emits (x, y, z, scale, instance) for the shell voxels:
// the top (k > TD - s), the bottom (k == BU, when include_btm) and every
// voxel of a border column (the map edge, or an 8-neighbour at stride s
// that differs in INS or TD).  Top facade voxels get the roof offset.
// Rows come out in row-major pixel order and ascending z, as the host
// extruder writes them.
//
// A column's rows are one run in closed form (``describe``): a border
// column emits the contiguous steps q_lo <= q < q_hi of its walk that lie
// under the z cap (z = BU + q s), any other column its bottom (when asked,
// and only where it is not also the top) and its top, each where it lies
// under the cap.  So row `rank` of a border column has z = k0 + rank * s,
// that of another column k0 then the top's z; a row is the top where z is
// the walk's last voxel.  The column length is floor((TD - BU) / s) + 1
// and 0 where TD < BU (C's truncating division would give 1 there).
// Neighbours are read only off the edge, where all of them lie inside the
// map.  Semantic ids at or above the table's length (the car sentinel)
// take its last entry.  With z_cap >= 0 only voxels with 0 <= k < z_cap
// count (the JAX grid's d_max layers).
//
// Two launches over tiles of TILE consecutive row-major pixels, one block
// a tile, and no per-pixel state in device memory:
//   A (count): each thread describes PIX pixels (neighbouring threads on
//     neighbouring pixels, a thread's map loads issued together); the
//     block's total goes to its tile's slot and is added (integer atomics:
//     exact in any order) to its group's total (GROUP tiles) and to the
//     grand total.  The launcher zeroes the group totals and the grand
//     total first (one memset, no kernel).  The exact form reads the grand
//     total on the host once; the padded form does not wait.
//   B (emit): a block's first row is the sum of the group totals before
//     its group and of the tile totals before it in its group: at most
//     ~T / GROUP + GROUP values from L2 (a decoupled look-back would need
//     tile flags reset before every call, a third launch, or state kept
//     between calls).  It describes its pixels again into shared memory,
//     scans their counts there, then emits the tile's rows as one
//     contiguous segment balanced over the threads, in chunks of CHUNK
//     rows: each pixel marks the row where its rows start, an inclusive max
//     scan over the chunk's rows gives every row its pixel (the last mark
//     at or before it, or the one carried from the chunk before), and row
//     slot t, t + BLOCK, ... takes its z from its rank in the column.  The
//     rows are staged in shared memory and written with 16-byte stores
//     over the segment, neighbouring lanes on neighbouring addresses
//     (chunks start on a multiple of 4 rows, so every staged chunk is
//     16-byte aligned; the words of a segment's ragged head and tail,
//     shared with the next tile's segment, are stored one by one).  Rows
//     at or above ``cap`` are not written; with cap above the total, the
//     blocks share the zero padding [total, cap) out in 16-byte stores.
// Each pixel's description comes from the same function in both passes,
// so count and emit cannot disagree.  No order depends on timing: two runs
// give bit-equal rows.
//
// What bounds it on an H100 (80GB HBM3, 700 W): bytes.  The function reads
// the maps once (7 bytes a pixel for the int16 PNG maps and a bool PTS)
// and writes 20 bytes a row; the rows are most of it (73 of 102 MB on a
// 2048-pixel Google Earth map).  This design reads the maps a second time
// in pass B (mostly from L2) and moves 8 bytes a tile and a group of
// totals; no per-pixel count or offset touches device memory.  On that
// map pass A takes ~33 us (its neighbour reads ~11 of them) and pass B
// ~83 us (~39 before it emits), against a bound of ~30 us for the whole
// function: both passes wait on the latency of their map reads more than
// on the memory's rate.
//
// ptxas (-O3, sm_90a, int16 and int32 maps alike): pass A 40 registers,
// 64 bytes of shared memory; pass B 48 registers, 45,168 bytes of shared
// memory; no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int PIX = 4;                // pixels a thread
constexpr int TILE = BLOCK * PIX;     // pixels a block (extrusion.E1_TILE)
constexpr int GROUP = 64;             // tiles a group (extrusion.E1_GROUP)
constexpr int CHUNK = 4 * BLOCK;      // rows staged at once
constexpr int MAX_SCALES = 16;        // extrusion.E1_MAX_SCALES
constexpr int WARPS = BLOCK / 32;
constexpr unsigned BORDER = 1u << 30, FACADE = 1u << 31;
static_assert(PIX == 4 && CHUNK == 4 * BLOCK,
              "a thread scans one int4 of counts and of row marks");

struct Params {
  const void* ins;
  const void* td;
  const void* bu;
  const unsigned char* pts;
  int h, w;
  int scales[MAX_SCALES];  // the class scale table, by value
  int n_scales;
  int bldg_min, car_min, facade_sem, car_sem, roof_offset;
  int include_btm;
  int z_cap;  // < 0: no cap
  int n_tiles, n_groups;
  // [0] the grand total, [1, 1 + n_groups) the group totals, then the
  // n_tiles tile totals
  long long* sums;
};

// One column's rows: row `rank` (0 <= rank < cnt) has z = k0 + rank * s
// in a border column, else k0 then klast; it is the top where z == klast.
struct Run {
  int cnt, k0, klast, ins;
  unsigned meta;  // scale | BORDER | FACADE
};

// A pixel's own map values.
struct Pixel {
  int v, top, btm;  // INS, TD_HF, BU_HF
  bool on;          // PTS
};

__device__ __forceinline__ int floor_div(int a, int b) {
  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int ceil_div(int a, int b) {
  // a >= 0, b > 0
  return (a + b - 1) / b;
}

__device__ __forceinline__ bool under_cap(const Params& p, int k) {
  return p.z_cap < 0 || (k >= 0 && k < p.z_cap);
}

template <typename T>
__device__ __forceinline__ Pixel load_pixel(const Params& p, int g,
                                            int n_pix) {
  Pixel x{0, 0, 0, false};
  if (g < n_pix) {
    x.on = p.pts[g] != 0;
    x.v = (int)((const T*)p.ins)[g];
    x.top = (int)((const T*)p.td)[g];
    x.btm = (int)((const T*)p.bu)[g];
  }
  return x;
}

// True where the 8 neighbours of pixel c at stride s equal v; the 8 loads
// are issued before any comparison.
template <typename T>
__device__ __forceinline__ bool neighbours_same(const T* m, int c, int w,
                                                int s, int v) {
  const int up = c - s * w, down = c + s * w;
  const int at[8] = {up - s, up, up + s, c - s, c + s,
                     down - s, down, down + s};
  bool same = true;
#pragma unroll
  for (int u = 0; u < 8; ++u) same &= (int)m[at[u]] == v;
  return same;
}

// The rows of pixel g's column.
template <typename T>
__device__ __forceinline__ Run describe(const Params& p, int g,
                                        const Pixel& x) {
  Run r{0, 0, 0, 0, 0u};
  if (!x.on) return r;
  const int sem = x.v >= p.car_min ? p.car_sem
                                   : (x.v >= p.bldg_min ? p.facade_sem : x.v);
  const int cls = sem < 0 ? 0 : (sem >= p.n_scales ? p.n_scales - 1 : sem);
  int s = p.scales[0];
#pragma unroll
  for (int u = 1; u < MAX_SCALES; ++u)
    if (cls == u) s = p.scales[u];
  const int top = x.top, btm = x.btm;
  const int n = top < btm ? 0 : floor_div(top - btm, s) + 1;
  if (n == 0) return r;
  const int i = g / p.w, j = g - i * p.w;
  bool border = j < s || j >= p.w - s - 1 || i < s || i >= p.h - s - 1;
  if (!border)  // off the edge: every neighbour lies inside the map
    border = !(neighbours_same((const T*)p.ins, g, p.w, s, x.v) &
               neighbours_same((const T*)p.td, g, p.w, s, top));
  r.klast = btm + (n - 1) * s;
  r.ins = x.v;
  r.meta = (unsigned)s | (border ? BORDER : 0u) |
           (sem == p.facade_sem ? FACADE : 0u);
  if (border) {
    int q_lo = 0, q_hi = n;
    if (p.z_cap >= 0) {
      if (btm < 0) q_lo = ceil_div(-btm, s);
      q_hi = p.z_cap <= btm ? 0 : min(n, ceil_div(p.z_cap - btm, s));
    }
    r.cnt = max(q_hi - q_lo, 0);
    r.k0 = btm + q_lo * s;
  } else {
    // the bottom (step 0, when asked) and the top, the walk's last voxel
    // (the only k > TD - s); once where they coincide
    const bool with_btm = p.include_btm && n > 1 && under_cap(p, btm);
    r.cnt = (int)with_btm + (int)under_cap(p, r.klast);
    r.k0 = with_btm ? btm : r.klast;
  }
  return r;
}

// The block's sum of x, in every thread.
__device__ __forceinline__ long long block_sum(long long x,
                                               long long* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int u = 0; u < WARPS; ++u) s += warp_sums[u];
  __syncthreads();
  return s;
}

// The block's exclusive prefix of x in thread order under MAX (else +),
// and in *total the whole block's; warp_vals is free again on return.
template <bool MAX>
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_vals,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int none = MAX ? -1 : 0;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = MAX ? max(incl, y) : incl + y;
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = none;
  if (lane == 31) warp_vals[warp] = incl;
  __syncthreads();
  int before = none, all = none;
#pragma unroll
  for (int u = 0; u < WARPS; ++u) {
    const int y = warp_vals[u];
    if (u < warp) before = MAX ? max(before, y) : before + y;
    all = MAX ? max(all, y) : all + y;
  }
  __syncthreads();
  *total = all;
  return MAX ? max(before, excl) : before + excl;
}

// Stores words [lo, hi) of out from stage (stage[0] is word base, base a
// multiple of 4): 16-byte stores where a quad lies inside, single words at
// the ragged ends; the quads strided over `n_threads` from `first`.
template <bool ZERO>
__device__ __forceinline__ void store_words(int* __restrict__ out,
                                            const int* stage, long long base,
                                            long long lo, long long hi,
                                            long long first,
                                            long long n_threads) {
  for (long long q = (lo >> 2) - (base >> 2) + first; base + 4 * q < hi;
       q += n_threads) {
    const long long wq = base + 4 * q;
    if (wq >= lo && wq + 4 <= hi) {
      *reinterpret_cast<int4*>(out + wq) =
          ZERO ? make_int4(0, 0, 0, 0)
               : *reinterpret_cast<const int4*>(stage + 4 * q);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (wq + e >= lo && wq + e < hi)
          out[wq + e] = ZERO ? 0 : stage[4 * q + e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    extrude_count_kernel(const __grid_constant__ Params p) {
  __shared__ long long warp_sums[WARPS];
  const int n_pix = p.h * p.w;
  const int base = blockIdx.x * TILE;
  Pixel x[PIX];
#pragma unroll
  for (int u = 0; u < PIX; ++u)
    x[u] = load_pixel<T>(p, base + u * BLOCK + threadIdx.x, n_pix);
  long long c = 0;
#pragma unroll
  for (int u = 0; u < PIX; ++u)
    c += describe<T>(p, base + u * BLOCK + threadIdx.x, x[u]).cnt;
  c = block_sum(c, warp_sums);
  if (threadIdx.x == 0) {
    p.sums[1 + p.n_groups + blockIdx.x] = c;
    if (c != 0) {
      atomicAdd((unsigned long long*)&p.sums[1 + blockIdx.x / GROUP],
                (unsigned long long)c);
      atomicAdd((unsigned long long*)&p.sums[0], (unsigned long long)c);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    extrude_emit_kernel(const __grid_constant__ Params p,
                        int* __restrict__ out, long long cap) {
  __shared__ __align__(16) int off[TILE + 1];  // counts, then their scan
  __shared__ int k0[TILE], klast[TILE], ins[TILE];
  __shared__ unsigned meta[TILE];
  // the pixel whose rows start at each row of the chunk (-1: none), then
  // the pixel of each row
  __shared__ __align__(16) int pixel_of[CHUNK];
  __shared__ __align__(16) int stage[CHUNK * 5];
  __shared__ long long warp_sums[WARPS];
  __shared__ int warp_vals[WARPS];

  const int tid = threadIdx.x, b = blockIdx.x;
  const long long* sums = p.sums;
  const long long total = sums[0];
  // the zero padding of the padded form, shared out over the grid
  store_words<true>(out, nullptr, 0, 5 * min(total, cap), 5 * cap,
                    (long long)b * BLOCK + tid, (long long)gridDim.x * BLOCK);

  const long long count = sums[1 + p.n_groups + b];
  if (count == 0) return;
  const int group = b / GROUP;
  long long before = 0;
  for (int u = tid; u < group; u += BLOCK) before += sums[1 + u];
  for (int u = group * GROUP + tid; u < b; u += BLOCK)
    before += sums[1 + p.n_groups + u];
  const long long first = block_sum(before, warp_sums);
  if (first >= cap) return;

  const int n_pix = p.h * p.w;
  const int base = b * TILE;
  Pixel x[PIX];
#pragma unroll
  for (int u = 0; u < PIX; ++u)
    x[u] = load_pixel<T>(p, base + u * BLOCK + tid, n_pix);
#pragma unroll
  for (int u = 0; u < PIX; ++u) {
    const int lp = u * BLOCK + tid;
    const Run r = describe<T>(p, base + lp, x[u]);
    off[lp] = r.cnt;
    k0[lp] = r.k0;
    klast[lp] = r.klast;
    ins[lp] = r.ins;
    meta[lp] = r.meta;
  }
  reinterpret_cast<int4*>(pixel_of)[tid] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  // exclusive scan of the counts in pixel order, PIX consecutive a thread
  int4 cnt = reinterpret_cast<const int4*>(off)[tid];
  int all;
  int4 at;
  at.x = block_exclusive_scan<false>(cnt.x + cnt.y + cnt.z + cnt.w,
                                     warp_vals, &all);
  at.y = at.x + cnt.x;
  at.z = at.y + cnt.y;
  at.w = at.z + cnt.z;
  reinterpret_cast<int4*>(off)[tid] = at;
  if (tid == 0) off[TILE] = all;  // == count
  __syncthreads();

  const long long end = min(first + count, cap);
  const int w = p.w;
  int carry = -1;  // the pixel of the chunk's rows before its first head
  for (long long chunk = first & ~3LL; chunk < end; chunk += CHUNK) {
    // each pixel marks the row where its rows start, if in this chunk
#pragma unroll
    for (int u = 0; u < PIX; ++u) {
      const int lp = u * BLOCK + tid;
      const long long row = first + off[lp];
      if (off[lp + 1] > off[lp] && row >= chunk && row < chunk + CHUNK)
        pixel_of[row - chunk] = lp;
    }
    __syncthreads();
    // a row's pixel is the last mark at or before it (an inclusive max
    // scan, 4 consecutive rows a thread)
    int4 mark = reinterpret_cast<const int4*>(pixel_of)[tid];
    mark.y = max(mark.y, mark.x);
    mark.z = max(mark.z, mark.y);
    mark.w = max(mark.w, mark.z);
    int last;
    const int from = max(block_exclusive_scan<true>(mark.w, warp_vals, &last),
                         carry);
    mark.x = max(mark.x, from);
    mark.y = max(mark.y, from);
    mark.z = max(mark.z, from);
    mark.w = max(mark.w, from);
    reinterpret_cast<int4*>(pixel_of)[tid] = mark;
    carry = max(carry, last);
    __syncthreads();
    for (int slot = tid; slot < CHUNK; slot += BLOCK) {
      const long long row = chunk + slot;
      if (row < first || row >= end) continue;
      const int lp = pixel_of[slot];
      const int rank = (int)(row - first) - off[lp];
      const unsigned m = meta[lp];
      const int s = (int)(m & (BORDER - 1));
      const int k = (m & BORDER) ? k0[lp] + rank * s
                                 : (rank ? klast[lp] : k0[lp]);
      const int g = base + lp;
      const int i = g / w;
      int* dst = stage + slot * 5;
      dst[0] = g - i * w;
      dst[1] = i;
      dst[2] = k;
      dst[3] = s;
      dst[4] = ins[lp] + ((k == klast[lp] && (m & FACADE)) ? p.roof_offset
                                                           : 0);
    }
    __syncthreads();
    store_words<false>(out, stage, 5 * chunk, 5 * max(first, chunk),
                       5 * min(end, chunk + CHUNK), tid, BLOCK);
    reinterpret_cast<int4*>(pixel_of)[tid] = make_int4(-1, -1, -1, -1);
    __syncthreads();
  }
}

template <typename T>
int launch(const Params& p, int* out, long long cap, cudaStream_t stream) {
  if (out == nullptr) {
    cudaError_t e = cudaMemsetAsync(p.sums, 0,
                                    sizeof(long long) * (1 + p.n_groups),
                                    stream);
    if (e != cudaSuccess) return (int)e;
    extrude_count_kernel<T><<<p.n_tiles, BLOCK, 0, stream>>>(p);
  } else {
    extrude_emit_kernel<T><<<p.n_tiles, BLOCK, 0, stream>>>(p, out, cap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Pass A when out is null (writes the tile, group and grand totals into
// sums, which holds 1 + ceil(T / GROUP) + T int64 for T = ceil(h w / TILE)
// tiles); pass B otherwise (reads them, writes rows [0, cap) of out: the
// rows below the total, zeros above it).  ins, td and bu are int16
// (map_bytes 2) or int32 (map_bytes 4); pts is a byte mask; scales is a
// host array of n_scales (1-16) entries in [1, 2^30), passed to the
// kernels by value.  out must be 16-byte aligned.
extern "C" int extrude(const void* ins, const void* td, const void* bu,
                       const unsigned char* pts, int map_bytes, int h, int w,
                       const int* scales, int n_scales, int bldg_min,
                       int car_min, int facade_sem, int car_sem,
                       int roof_offset, int include_btm, int z_cap,
                       long long* sums, long long n_sums, int* out,
                       long long cap, void* stream) {
  if (h < 0 || w < 0 || n_scales < 1 || n_scales > MAX_SCALES ||
      sums == nullptr || cap < 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)h * w;
  if (n_pix == 0) return 0;
  // pixel indices (and the last tile's end) are int
  if (n_pix > 0x7fffffffLL - TILE) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n_pix + TILE - 1) / TILE;
  const long long n_groups = (n_tiles + GROUP - 1) / GROUP;
  if (n_sums < 1 + n_groups + n_tiles) return (int)cudaErrorInvalidValue;
  Params p{};
  p.ins = ins;
  p.td = td;
  p.bu = bu;
  p.pts = pts;
  p.h = h;
  p.w = w;
  for (int u = 0; u < MAX_SCALES; ++u) {
    p.scales[u] = scales[u < n_scales ? u : n_scales - 1];
    if (p.scales[u] < 1 || p.scales[u] >= (int)BORDER)
      return (int)cudaErrorInvalidValue;
  }
  p.n_scales = n_scales;
  p.bldg_min = bldg_min;
  p.car_min = car_min;
  p.facade_sem = facade_sem;
  p.car_sem = car_sem;
  p.roof_offset = roof_offset;
  p.include_btm = include_btm;
  p.z_cap = z_cap;
  p.n_tiles = (int)n_tiles;
  p.n_groups = (int)n_groups;
  p.sums = sums;
  if (out != nullptr && cap == 0) return 0;
  if (map_bytes == 2) return launch<short>(p, out, cap, (cudaStream_t)stream);
  if (map_bytes == 4) return launch<int>(p, out, cap, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* extrude_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
