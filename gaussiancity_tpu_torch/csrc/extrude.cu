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
// Two passes over the same column walk (``visit_column``), one thread a
// pixel: the count pass writes each pixel's row count; the caller scans
// the counts in row-major order (torch.cumsum, int64); the emit pass
// writes each pixel's rows at its offset.  No atomics: the order is fixed
// by the scan.  A column that is not border emits at most two rows (its
// bottom and its top, the walk's last voxel), so only border columns walk
// their whole height.  The column length is floor((TD - BU) / s) + 1 and
// 0 where TD < BU (C's truncating division would give 1 there).  A
// pixel's neighbours are read only when it is off the edge, where all of
// them lie inside the map.  Semantic ids at or above the table's length
// (the car sentinel) take its last entry.  With z_cap >= 0 only voxels
// with 0 <= k < z_cap count (the JAX grid's d_max layers); the emit pass
// writes rows below ``cap`` only.
//
// The three height and instance maps are read as the caller holds them,
// int16 (the PNG maps) or int32 (``map_bytes`` says which), and PTS as a
// byte mask (bool), so no widening copy precedes a launch.
//
// What bounds it on an H100 (80GB HBM3, 700 W): bytes.  The function
// reads four maps (2 + 2 + 2 + 1 bytes a pixel for the PNG maps) and
// writes 20 bytes a row; the counts (4 bytes a pixel, twice) and the
// int64 scan (8 bytes a pixel, written and read) are this design's extra
// traffic, and the scan and the host's read of the total are its extra
// latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

template <typename T>
struct Maps {
  const T* ins;
  const T* td;
  const T* bu;
  const unsigned char* pts;
  int h, w;
  const int* scales;
  int n_scales;
  int bldg_min, car_min, facade_sem, car_sem, roof_offset;
  bool include_btm;
  int z_cap;  // < 0: no cap
};

__device__ __forceinline__ int floor_div(int a, int b) {
  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <typename T>
__device__ __forceinline__ bool neighbours_same(const T* m, int i, int j,
                                                int w, int s) {
  const long long c = (long long)i * w + j;
  const T v = m[c];
  const long long up = c - (long long)s * w, down = c + (long long)s * w;
  return m[up - s] == v && m[up] == v && m[up + s] == v && m[c - s] == v &&
         m[c + s] == v && m[down - s] == v && m[down] == v &&
         m[down + s] == v;
}

struct Column {
  int i, j, ins, s, td, bu;
  bool facade;
};

// Step q of the column's walk, the voxel k = BU + q * s: counts 1 when it
// lies under the z cap, and with EMIT writes its row at out_row when that
// is below cap.
template <bool EMIT, typename T>
__device__ __forceinline__ int visit_step(const Maps<T>& p, const Column& c,
                                          int q, int* out, long long out_row,
                                          long long cap) {
  const int k = c.bu + q * c.s;
  if (p.z_cap >= 0 && (k < 0 || k >= p.z_cap)) return 0;
  if (EMIT && out_row < cap) {
    const bool top = k > c.td - c.s;
    int* row = out + out_row * 5;
    row[0] = c.j;
    row[1] = c.i;
    row[2] = k;
    row[3] = c.s;
    row[4] = (top && c.facade) ? c.ins + p.roof_offset : c.ins;
  }
  return 1;
}

// Walks pixel (i, j)'s column; with EMIT writes its rows from out_row on
// (those below cap).  Returns the number of rows the column emits.
template <bool EMIT, typename T>
__device__ int visit_column(const Maps<T>& p, int i, int j, int* out,
                            long long out_row, long long cap) {
  const long long idx = (long long)i * p.w + j;
  if (!p.pts[idx]) return 0;
  const int ins = (int)p.ins[idx];
  const int sem = ins >= p.car_min
                      ? p.car_sem
                      : (ins >= p.bldg_min ? p.facade_sem : ins);
  const int cls = sem < 0 ? 0 : (sem >= p.n_scales ? p.n_scales - 1 : sem);
  const Column c{i, j, ins, p.scales[cls], (int)p.td[idx], (int)p.bu[idx],
                 sem == p.facade_sem};
  const int n = c.td < c.bu ? 0 : floor_div(c.td - c.bu, c.s) + 1;
  if (n == 0) return 0;
  const bool border =
      j < c.s || j >= p.w - c.s - 1 || i < c.s || i >= p.h - c.s - 1 ||
      !neighbours_same(p.ins, i, j, p.w, c.s) ||
      !neighbours_same(p.td, i, j, p.w, c.s);
  int count = 0;
  if (border) {
    for (int q = 0; q < n; ++q)
      count += visit_step<EMIT>(p, c, q, out, out_row + count, cap);
    return count;
  }
  // not border: the bottom (step 0, when asked) and the top, the walk's
  // last voxel (the only k > TD - s); once where they coincide
  if (p.include_btm && n > 1)
    count += visit_step<EMIT>(p, c, 0, out, out_row, cap);
  return count + visit_step<EMIT>(p, c, n - 1, out, out_row + count, cap);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    extrude_count_kernel(Maps<T> p, int* __restrict__ counts) {
  const long long idx = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (idx >= (long long)p.h * p.w) return;
  const int i = (int)(idx / p.w), j = (int)(idx % p.w);
  counts[idx] = visit_column<false>(p, i, j, nullptr, 0, 0);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) extrude_emit_kernel(
    Maps<T> p, const int* __restrict__ counts,
    const long long* __restrict__ incl, int* __restrict__ out,
    long long cap) {
  const long long idx = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (idx >= (long long)p.h * p.w) return;
  const int c = counts[idx];
  if (c == 0) return;
  const long long start = incl[idx] - c;
  if (start >= cap) return;
  const int i = (int)(idx / p.w), j = (int)(idx % p.w);
  visit_column<true>(p, i, j, out, start, cap);
}

template <typename T>
int launch(const void* ins, const void* td, const void* bu,
           const unsigned char* pts, int h, int w, const int* scales,
           int n_scales, int bldg_min, int car_min, int facade_sem,
           int car_sem, int roof_offset, int include_btm, int z_cap,
           int* counts, const long long* incl, int* out, long long cap,
           cudaStream_t stream) {
  const long long n_pix = (long long)h * w;
  if (n_pix == 0) return 0;
  Maps<T> p{(const T*)ins, (const T*)td, (const T*)bu, pts,
            h,            w,           scales,      n_scales,
            bldg_min,     car_min,     facade_sem,  car_sem,
            roof_offset,  include_btm != 0, z_cap};
  const unsigned grid = (unsigned)((n_pix + BLOCK - 1) / BLOCK);
  if (out == nullptr) {
    extrude_count_kernel<T><<<grid, BLOCK, 0, stream>>>(p, counts);
  } else {
    if (incl == nullptr) return (int)cudaErrorInvalidValue;
    extrude_emit_kernel<T><<<grid, BLOCK, 0, stream>>>(p, counts, incl,
                                                        out, cap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Count pass when out is null (writes counts); emit pass otherwise (reads
// counts and their inclusive int64 scan incl, writes rows below cap).
// ins, td and bu are int16 (map_bytes 2) or int32 (map_bytes 4); pts is a
// byte mask.
extern "C" int extrude(const void* ins, const void* td, const void* bu,
                       const unsigned char* pts, int map_bytes, int h, int w,
                       const int* scales, int n_scales, int bldg_min,
                       int car_min, int facade_sem, int car_sem,
                       int roof_offset, int include_btm, int z_cap,
                       int* counts, const long long* incl, int* out,
                       long long cap, void* stream) {
  if (h < 0 || w < 0 || n_scales < 1) return (int)cudaErrorInvalidValue;
  if (map_bytes == 2)
    return launch<short>(ins, td, bu, pts, h, w, scales, n_scales, bldg_min,
                         car_min, facade_sem, car_sem, roof_offset,
                         include_btm, z_cap, counts, incl, out, cap,
                         (cudaStream_t)stream);
  if (map_bytes == 4)
    return launch<int>(ins, td, bu, pts, h, w, scales, n_scales, bldg_min,
                       car_min, facade_sem, car_sem, roof_offset,
                       include_btm, z_cap, counts, incl, out, cap,
                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* extrude_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
