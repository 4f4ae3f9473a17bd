// Kernel K1: tile-local front-to-back alpha blending (forward).
//
// Replaces gaussiancity_tpu/ops/rasterizer/blend_pallas.py::_fwd_kernel
// (launched there by blend_tiles_pallas_fwd, after blend.py::_gather_pack
// has materialised the [T, K/page, 16, page] slot attributes and
// _stamp_gate_mask has precomputed the 16x16 gate bitmask).
//
// Layout: one thread block per pixel tile, one thread per pixel (upstream
// renderCUDA, forward.cu:238-346).  Each block walks its tile's slot list
// in batches of BATCH slots: the first BATCH threads gather the slots'
// attribute rows from attrs[N, 10] through gauss_index[T, K] (fusing the
// gather the JAX package materialises) into shared memory, together with
// the slot's 16x16-block getRect bounds, and every pixel then reads the
// batch as broadcasts.  The reference gate is computed here from mx, my
// and radius with the same f32 floor(x * 0.0625) formulas as
// blend.py::_rect16_gate: no stamp pass and no bitmask width limit.
//
// What bounds it on an H100: arithmetic.  Every evaluated pixel-slot pair
// costs ~25 fp32 operations and one expf, while the bytes are small: the
// slot rows are read once per tile and the outputs written once.  The
// per-pixel loop is sequential in k, so the design's levers are (a) the
// early exit, per pixel at saturation and per block once every pixel is
// done (__syncthreads_count) or the count is reached, and (b) shared
// memory broadcasts so that no pixel thread touches device memory inside
// the loop.  Tensor cores do not apply to this recurrence.
//
// Numerics: expf (not __expf), no fast math, and -fmad=false at build
// time, so that this kernel and the plain PyTorch version
// (ops/rasterizer/blend.py::blend_forward_plain) round alike at the
// power <= 0, alpha >= alpha_min and T < t_eps thresholds.

#include <cuda_runtime.h>

namespace {

constexpr int BATCH = 256;
constexpr int N_ROWS = 13;  // mx my ca cb cc op r g b xlo xhi ylo yhi
constexpr int ATTR_COLS = 10;

__global__ void __launch_bounds__(1024) blend_fwd_kernel(
    const float* __restrict__ attrs, const int* __restrict__ gauss_index,
    const int* __restrict__ counts, const float* __restrict__ bg, int K,
    int n_tx, int tile_h, int tile_w, int img_h, int img_w, float origin_x,
    float origin_y, int ref_gate, float alpha_min, float alpha_max,
    float t_eps, float* __restrict__ image, float* __restrict__ final_T,
    int* __restrict__ n_contrib) {
  __shared__ float s[N_ROWS][BATCH];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int tx = tile % n_tx, ty = tile / n_tx;
  const int ix = tid % tile_w, iy = tid / tile_w;
  const int gx = tx * tile_w + ix, gy = ty * tile_h + iy;
  const bool inside = gx < img_w && gy < img_h;
  // window renders shift the pixel origin (sensor coords), not the means
  const float x0 = (float)(tx * tile_w) + origin_x;
  const float y0 = (float)(ty * tile_h) + origin_y;
  const float px = x0 + (float)ix;
  const float py = y0 + (float)iy;
  const float bx16 = floorf(px * 0.0625f);
  const float by16 = floorf(py * 0.0625f);
  const int count = counts[tile];

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int nc = 0;
  bool done = !inside;
  for (int base = 0; base < count; base += BATCH) {
    // block-wide barrier: exit once every pixel of the tile is done; it
    // also orders the previous batch's reads before this batch's writes
    if (__syncthreads_count(done) == n_threads) break;
    const int n = min(BATCH, count - base);
    if (tid < n) {
      const int g = gauss_index[(size_t)tile * K + base + tid];
      const float* a = attrs + (size_t)g * ATTR_COLS;
      const float mx = a[0], my = a[1], rd = a[9];
      #pragma unroll
      for (int r = 0; r < 9; ++r) s[r][tid] = a[r];
      s[9][tid] = floorf((mx - rd) * 0.0625f);
      s[10][tid] = floorf((mx + rd + 15.0f) * 0.0625f);
      s[11][tid] = floorf((my - rd) * 0.0625f);
      s[12][tid] = floorf((my + rd + 15.0f) * 0.0625f);
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float dx = s[0][j] - px;
        const float dy = s[1][j] - py;
        const float power =
            -0.5f * (s[2][j] * dx * dx + s[4][j] * dy * dy) -
            s[3][j] * dx * dy;
        if (!(power <= 0.0f)) continue;
        const float a = s[5][j] * expf(power);
        const float alpha = a > alpha_max ? alpha_max : a;
        if (!(alpha >= alpha_min)) continue;
        if (ref_gate && !(bx16 >= s[9][j] && bx16 < s[10][j] &&
                          by16 >= s[11][j] && by16 < s[12][j]))
          continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < t_eps) {
          done = true;
          break;
        }
        const float w = alpha * T;
        c0 = c0 + w * s[6][j];
        c1 = c1 + w * s[7][j];
        c2 = c2 + w * s[8][j];
        T = test_T;
        nc = base + j + 1;
      }
    }
  }
  if (inside) {
    const size_t hw = (size_t)img_h * img_w;
    const size_t p = (size_t)gy * img_w + gx;
    image[p] = c0 + T * bg[0];
    image[hw + p] = c1 + T * bg[1];
    image[2 * hw + p] = c2 + T * bg[2];
    final_T[p] = T;
    n_contrib[p] = nc;
  }
}

}  // namespace

extern "C" int blend_fwd(const float* attrs, const int* gauss_index,
                         const int* counts, const float* bg, int T, int K,
                         int n_tx, int tile_h, int tile_w, int img_h,
                         int img_w, float origin_x, float origin_y,
                         int ref_gate, float alpha_min, float alpha_max,
                         float t_eps, float* image, float* final_T,
                         int* n_contrib, void* stream) {
  blend_fwd_kernel<<<T, tile_h * tile_w, 0, (cudaStream_t)stream>>>(
      attrs, gauss_index, counts, bg, K, n_tx, tile_h, tile_w, img_h, img_w,
      origin_x, origin_y, ref_gate, alpha_min, alpha_max, t_eps, image,
      final_T, n_contrib);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
