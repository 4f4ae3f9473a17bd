// Kernel K1: tile-local front-to-back alpha blending (forward).
//
// Replaces gaussiancity_tpu/ops/rasterizer/blend_pallas.py::_fwd_kernel
// (launched there by blend_tiles_pallas_fwd, after blend.py::_gather_pack
// has materialised the [T, K/page, 16, page] slot attributes and
// _stamp_gate_mask has precomputed the 16x16 gate bitmask).
//
// Semantics (upstream renderCUDA, forward.cu:238-346): every pixel walks
// its tile's slots front to back; a slot is eligible iff power <= 0,
// alpha >= alpha_min and (with the reference gate) the pixel's 16x16
// sensor block lies in the slot's getRect bbox; an eligible slot blends
// unless T * (1 - alpha) < t_eps, which ends the pixel.
//
// Layout (blend_common.cuh): persistent blocks of 256 threads, one per
// pixel, take work units, a sub-tile each (16x16 of a 32x32 tile), from a
// global counter in the order tile_prep_kernel gives: tiles with the most
// slots first, so that the last units to start are short ones.  A unit
// walks its tile's slots in batches of 256: the rows of batch b + 1 are
// gathered by cp.async (tracked by an mbarrier) while batch b is blended;
// each batch is culled for the sub-tile and compacted, with the slots'
// original indices (n_contrib = k + 1), into a ring that every pixel
// reads as broadcasts.  A warp stops once its pixels are done; a unit stops once
// all of them are (the count is taken at the batch's first barrier).
//
// What bounds it on an H100: instruction issue.  A (pixel, kept slot)
// pair costs ~23 instructions up to the alpha-floor test (9 of them the
// ring loads and the loop) and ~30 more with expf where the slot can
// reach alpha_min; the bytes (slot rows from L2, one write per output)
// are small.  The levers are the pairs that the cull and the alpha floor
// leave out and the load balance; pixels saturate at nearly the same slot
// within a warp's 8 x 4 block (1.5 % over the mean on the frame).  Two
// pixels per thread, sharing the slot's loads, measured slower (more
// divergent regions per slot).  Tensor cores do not apply.
//
// Numerics: expf (not __expf), no fast math, and -fmad=false at build
// time, so that this kernel and the plain PyTorch version
// (ops/rasterizer/blend.py::blend_forward_plain) round alike at the
// power <= 0, alpha >= alpha_min and T < t_eps thresholds: the image,
// final_T and n_contrib are bit-equal.

#include <climits>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int THREADS = 256;  // one thread per pixel of a sub-tile
constexpr int BATCH = THREADS;  // slots staged per batch, one per thread

__global__ void __launch_bounds__(THREADS) blend_fwd_kernel(
    const float* __restrict__ attrs, const int* __restrict__ gauss_index,
    const int* __restrict__ counts, const float* __restrict__ bg, Geom g,
    int ref_gate, float alpha_min, float alpha_max, float t_eps,
    const int* __restrict__ order, int* __restrict__ unit_counter,
    float* __restrict__ image, float* __restrict__ final_T,
    int* __restrict__ n_contrib) {
  __shared__ __align__(16) Staging<BATCH> stg;
  __shared__ Ring<BATCH> ring;
  __shared__ int warp_n[THREADS / 32];
  __shared__ int unit_s;
  const int tid = threadIdx.x;
  staging_init<THREADS>(stg);
  unsigned issued = 0, waited = 0;  // batches staged / consumed
  const int n_units = g.T * g.n_sub;
  while (true) {
    if (tid == 0) unit_s = atomicAdd(unit_counter, 1);
    __syncthreads();
    const int u = unit_s;
    if (u >= n_units) break;
    const int tile = order[u / g.n_sub];
    const SubTile<1> s = locate<THREADS, 1>(g, tile, u % g.n_sub, tid);
    if (!s.empty) {
      const bool gate_px = ref_gate && !s.one_block;
      const Pixel& q = s.p[0];
      const int count = counts[tile];
      const int* idx = gauss_index + (size_t)tile * g.K;
      float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
      int nc = 0;
      bool done = !q.inside;
      // batch 0's rows in flight, batch 1's index in a register.  A unit
      // stages only when its tile has slots (count is the block's), so
      // every staged batch is waited for: a barrier's phases never run
      // two ahead of a wait on its parity, and no copy or arrival is in
      // flight when the block exits
      bool v = tid < count;
      int gi = v ? idx[tid] : 0;
      if (count > 0) {
        stage_row(stg.row[issued & 1][tid], attrs, gi, v,
                  &stg.bar[issued & 1]);
        ++issued;
      }
      v = BATCH + tid < count;
      gi = v ? idx[BATCH + tid] : 0;
      for (int base = 0; base < count; base += BATCH) {
        mbar_wait(&stg.bar[waited & 1], (waited >> 1) & 1);
        const float2* row = stg.row[waited & 1][tid];
        ++waited;
        int n_done;
        const int n_kept =
            compact<THREADS>(row, base + tid < count, base + tid, s,
                             ref_gate, alpha_min, ring, warp_n, done, n_done);
        if (n_done == THREADS) break;
        if (base + BATCH < count) {
          stage_row(stg.row[issued & 1][tid], attrs, gi, v,
                    &stg.bar[issued & 1]);
          ++issued;
          const int nxt = base + 2 * BATCH + tid;
          v = nxt < count;
          gi = v ? idx[nxt] : 0;
        }
        if (done) continue;
        for (int j = 0; j < n_kept; ++j) {
          const float4 ga = ring.geo[j];
          const float4 gb = ring.aux[j];
          const float dx = ga.x - q.px;
          const float dy = ga.y - q.py;
          const float power =
              -0.5f * (ga.z * dx * dx + gb.x * dy * dy) - ga.w * dx * dy;
          if (!(power >= gb.y)) continue;  // alpha < alpha_min here
          if (!(power <= 0.0f)) continue;
          if (gate_px) {
            const float4 gt = ring.gate[j];
            if (!(q.bx16 >= gt.x && q.bx16 < gt.y && q.by16 >= gt.z &&
                  q.by16 < gt.w))
              continue;
          }
          const float4 cl = ring.col[j];
          const float a = cl.x * expf(power);
          const float alpha = a > alpha_max ? alpha_max : a;
          if (!(alpha >= alpha_min)) continue;
          const float test_T = T * (1.0f - alpha);
          if (test_T < t_eps) {
            done = true;
            break;
          }
          const float w = alpha * T;
          c0 = c0 + w * cl.y;
          c1 = c1 + w * cl.z;
          c2 = c2 + w * cl.w;
          T = test_T;
          nc = __float_as_int(gb.z);
        }
      }
      if (q.inside) {
        const size_t hw = (size_t)g.img_h * g.img_w;
        const size_t p = (size_t)q.gy * g.img_w + q.gx;
        image[p] = c0 + T * bg[0];
        image[hw + p] = c1 + T * bg[1];
        image[2 * hw + p] = c2 + T * bg[2];
        final_T[p] = T;
        n_contrib[p] = nc;
      }
    }
    __syncthreads();  // every thread has read unit_s
  }
}

// The persistent grid: SMs times the blend kernel's resident blocks,
// queried once per device (a frame launches K1 every time it renders).
int persistent_blocks() {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, blend_fwd_kernel,
                                                THREADS, 0);
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < MAX_DEVICES) cached[dev] = n;
  return n;
}

}  // namespace

// scratch: T + 1 int32 (the tile order and the work-unit counter), written
// here before the blend.
extern "C" int blend_fwd(const float* attrs, const int* gauss_index,
                         const int* counts, const float* bg, int T, int K,
                         int n_tx, int tile_h, int tile_w, int sub_h,
                         int sub_w, int img_h, int img_w, float origin_x,
                         float origin_y, int ref_gate, float alpha_min,
                         float alpha_max, float t_eps, int* scratch,
                         float* image, float* final_T, int* n_contrib,
                         void* stream) {
  Geom g;
  // any number of sub-tiles a tile: K1's blocks do not share them
  const int bad = make_geom(g, T, K, n_tx, tile_h, tile_w, sub_h, sub_w,
                            img_h, img_w, origin_x, origin_y, INT_MAX);
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  int* order = scratch;
  int* counter = scratch + T;
  tile_prep_kernel<<<1, PREP_THREADS, 0, s>>>(counts, T, K, order, nullptr,
                                              counter);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = min(persistent_blocks(), T * g.n_sub);
  if (blocks > 0)
    blend_fwd_kernel<<<blocks, THREADS, 0, s>>>(
        attrs, gauss_index, counts, bg, g, ref_gate, alpha_min, alpha_max,
        t_eps, order, counter, image, final_T, n_contrib);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
