// Native footprint extruder — the host counterpart of kernel E1.
//
// Re-implementation of the reference CPU extruder semantics
// (reference: extensions/footprint_extruder/footprint_extruder.cpp:100-222)
// as a plain C ABI shared library driven through ctypes (no CPython API,
// no torch).  The port's dataset path extrudes on the card (kernel E1,
// csrc/extrude.cu, through ops/extrusion.py); this library is the host
// version that the chip smoke run times beside it.
//
// Semantics mirrored exactly:
//  - emit only where the PTS stride mask is set
//  - semantic id: < bldg_min -> itself; >= car_min -> car; else facade
//  - per-pixel z-walk k = BU, BU+s, ..., <= TD (s = class scale)
//  - hollow shell: keep top-of-column (k > TD - s), bottom (k == BU when
//    include_btm), map-edge pixels, or pixels whose 8-neighborhood at
//    stride s differs in INS or TD
//  - top facade voxels get instance += roof_offset
//
// Build: g++ -O3 -shared -fPIC -fopenmp -std=c++17

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int64_t idx2(int32_t y, int32_t x, int32_t w) {
  return static_cast<int64_t>(y) * w + x;
}

inline bool neighbors_same(const int16_t *m, int32_t x, int32_t y, int32_t w,
                           int32_t s) {
  const int16_t c = m[idx2(y, x, w)];
  return m[idx2(y - s, x - s, w)] == c && m[idx2(y - s, x, w)] == c &&
         m[idx2(y - s, x + s, w)] == c && m[idx2(y, x - s, w)] == c &&
         m[idx2(y, x + s, w)] == c && m[idx2(y + s, x - s, w)] == c &&
         m[idx2(y + s, x, w)] == c && m[idx2(y + s, x + s, w)] == c;
}

struct Params {
  const int16_t *ins;
  const int16_t *td;
  const int16_t *bu;
  const uint8_t *pts;
  int32_t height, width;
  const int16_t *class_scales;
  int32_t n_scales;
  int16_t bldg_min, car_min, facade_sem, car_sem, roof_offset;
  bool include_btm;
};

inline int16_t semantic_id(int16_t instance, const Params &p) {
  if (instance < p.bldg_min) return instance;
  if (instance >= p.car_min) return p.car_sem;
  return p.facade_sem;
}

// Emit the points of rows [y0, y1) into `out` (rows of 5 int32), capped at
// cap rows. Returns the number of rows that WOULD be emitted (may exceed
// cap — callers compare to detect truncation).
int64_t extrude_rows(const Params &p, int32_t y0, int32_t y1, int32_t *out,
                     int64_t cap) {
  const int32_t w = p.width, h = p.height;
  int64_t n = 0;
  for (int32_t i = y0; i < y1; ++i) {
    for (int32_t j = 0; j < w; ++j) {
      const int64_t idx = idx2(i, j, w);
      if (!p.pts[idx]) continue;
      const int16_t instance = p.ins[idx];
      const int16_t sem = semantic_id(instance, p);
      const int16_t cls = (sem >= 0 && sem < p.n_scales) ? sem
                                                         : (p.n_scales - 1);
      const int16_t s = p.class_scales[cls];
      const int16_t td = p.td[idx], bu = p.bu[idx];
      const bool at_edge =
          (j < s || j >= w - s - 1 || i < s || i >= h - s - 1);
      // neighborhood tests are z-invariant; hoist out of the z-walk
      const bool nb_border =
          at_edge || !neighbors_same(p.ins, j, i, w, s) ||
          !neighbors_same(p.td, j, i, w, s);
      for (int32_t k = bu; k <= td; k += s) {
        const bool is_top = k > td - s;
        const bool is_btm = p.include_btm && k == bu;
        if (!(is_top || is_btm || nb_border)) continue;
        int32_t out_id = instance;
        if (is_top && sem == p.facade_sem) out_id += p.roof_offset;
        if (n < cap) {
          int32_t *row = out + n * 5;
          row[0] = j;
          row[1] = i;
          row[2] = k;
          row[3] = s;
          row[4] = out_id;
        }
        ++n;
      }
    }
  }
  return n;
}

}  // namespace

extern "C" {

// Returns the number of points that WOULD be produced; writes at most
// max_out rows into `out`.  Call once with max_out=0 to size, or with a
// generous cap and check the return value.
int64_t gct_extrude_points(const int16_t *ins, const int16_t *td,
                           const int16_t *bu, const uint8_t *pts_map,
                           int32_t height, int32_t width,
                           const int16_t *class_scales, int32_t n_scales,
                           int16_t bldg_min, int16_t car_min,
                           int16_t facade_sem, int16_t car_sem,
                           int16_t roof_offset, int32_t include_btm,
                           int32_t *out, int64_t max_out, int32_t n_threads) {
  Params p{ins,      td,      bu,         pts_map, height,
           width,    class_scales, n_scales, bldg_min, car_min,
           facade_sem, car_sem, roof_offset, include_btm != 0};
#ifdef _OPENMP
  if (n_threads > 1 && height >= 4 * n_threads) {
    // two-pass: count per band, then emit at exact offsets (keeps the
    // reference's row-major output order deterministically)
    std::vector<int64_t> band_counts(n_threads, 0);
    std::vector<int32_t> bounds(n_threads + 1);
    for (int32_t t = 0; t <= n_threads; ++t)
      bounds[t] = static_cast<int32_t>(
          static_cast<int64_t>(height) * t / n_threads);
#pragma omp parallel num_threads(n_threads)
    {
      const int t = omp_get_thread_num();
      band_counts[t] = extrude_rows(p, bounds[t], bounds[t + 1], nullptr, 0);
    }
    std::vector<int64_t> offsets(n_threads + 1, 0);
    for (int32_t t = 0; t < n_threads; ++t)
      offsets[t + 1] = offsets[t] + band_counts[t];
#pragma omp parallel num_threads(n_threads)
    {
      const int t = omp_get_thread_num();
      const int64_t off = offsets[t];
      if (off < max_out) {
        extrude_rows(p, bounds[t], bounds[t + 1], out + off * 5,
                     max_out - off);
      }
    }
    return offsets[n_threads];
  }
#endif
  return extrude_rows(p, 0, height, out, max_out);
}

}  // extern "C"
