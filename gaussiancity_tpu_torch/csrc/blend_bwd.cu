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
// Output: grads [T * K, 9], slot-major (row tile * K + k), the per-slot
// sums over the tile's pixels; rows k >= k_hi are written as zeros.  The
// caller reduces the rows to per-Gaussian gradients (kernel K3).
//
// Layout: one thread block per pixel tile, one thread per pixel, as K1.
// Slots are walked in batches of BATCH: the first BATCH threads stage the
// batch's attribute rows (read from attrs[N, 10] through gauss_index) and
// gate bounds in shared memory; every pixel then replays the batch back
// to front and each warp reduces its 9 per-slot values with shuffles into
// shared memory; after one barrier the block adds the warps' partial sums
// in a fixed order and writes the batch's rows.  No atomics: the result
// is the same on every run.  Out-of-image pixels of edge tiles add
// nothing.  Window renders shift the pixel origin, never the means.
//
// What bounds it on an H100: arithmetic, as for K1 (~40 fp32 operations,
// one expf and one division per counted (pixel, slot) pair, plus the
// per-slot reductions); bytes are the slot rows read once per tile, the
// four pixel planes read once and the [T*K, 9] rows written once.  The
// TPU kernel's pixel-moment matmuls exist for the MXU and are not carried
// over; the reductions here are warp shuffles.
//
// Numerics: expf (not __expf), IEEE division, no fast math, and
// -fmad=false at build time, so that every pixel's terms equal those of
// the plain PyTorch version (ops/rasterizer/blend.py::blend_backward_plain)
// bit for bit; only the order of the sums over the pixels differs.

#include <cuda_runtime.h>

namespace {

constexpr int BATCH = 32;
constexpr int N_ROWS = 13;  // mx my ca cb cc op r g b xlo xhi ylo yhi
constexpr int ATTR_COLS = 10;
constexpr int N_GRAD = 9;
constexpr int MAX_WARPS = 32;

__global__ void __launch_bounds__(1024) blend_bwd_kernel(
    const float* __restrict__ attrs, const int* __restrict__ gauss_index,
    const int* __restrict__ k_hi, int K, int n_tx, int tile_h, int tile_w,
    int img_h, int img_w, float origin_x, float origin_y, int ref_gate,
    float alpha_min, float alpha_max, const float* __restrict__ g_out,
    const float* __restrict__ bg_dot_g, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, float* __restrict__ grads) {
  __shared__ float s[N_ROWS][BATCH];
  __shared__ float part[MAX_WARPS][BATCH][N_GRAD];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = n_threads >> 5;
  const int tx = tile % n_tx, ty = tile / n_tx;
  const int ix = tid % tile_w, iy = tid / tile_w;
  const int gx = tx * tile_w + ix, gy = ty * tile_h + iy;
  const bool inside = gx < img_w && gy < img_h;
  const float px = (float)(tx * tile_w) + origin_x + (float)ix;
  const float py = (float)(ty * tile_h) + origin_y + (float)iy;
  const float bx16 = floorf(px * 0.0625f);
  const float by16 = floorf(py * 0.0625f);
  const int khi = k_hi[tile];
  float* out = grads + (size_t)tile * K * N_GRAD;
  for (int i = khi * N_GRAD + tid; i < K * N_GRAD; i += n_threads) {
    out[i] = 0.0f;
  }

  // per-pixel state; out-of-image pixels have no slot (nc = 0) and zero
  // cotangents, so they add exact zeros to the sums
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, bgg = 0.0f, fT = 1.0f;
  int nc = 0;
  if (inside) {
    const size_t hw = (size_t)img_h * img_w;
    const size_t p = (size_t)gy * img_w + gx;
    g0 = g_out[p];
    g1 = g_out[hw + p];
    g2 = g_out[2 * hw + p];
    bgg = bg_dot_g[p];
    fT = final_T[p];
    nc = n_contrib[p];
  }
  float T = fT;
  float ar0 = 0.0f, ar1 = 0.0f, ar2 = 0.0f;
  float la = 0.0f, lc0 = 0.0f, lc1 = 0.0f, lc2 = 0.0f;

  for (int end = khi; end > 0; end -= BATCH) {
    const int start = end > BATCH ? end - BATCH : 0;
    const int n = end - start;
    // the previous batch's reads of s and part are done
    __syncthreads();
    if (tid < n) {
      const int g = gauss_index[(size_t)tile * K + start + tid];
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
    for (int j = n - 1; j >= 0; --j) {
      const int k = start + j;
      float v[N_GRAD];
#pragma unroll
      for (int i = 0; i < N_GRAD; ++i) v[i] = 0.0f;
      const float ca = s[2][j], cb = s[3][j], cc = s[4][j], op = s[5][j];
      const float dx = s[0][j] - px;
      const float dy = s[1][j] - py;
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      const float G = expf(power);
      const float a = op * G;
      const float alpha = a > alpha_max ? alpha_max : a;
      bool ok = k < nc && power <= 0.0f && alpha >= alpha_min;
      if (ref_gate) {
        ok = ok && bx16 >= s[9][j] && bx16 < s[10][j] && by16 >= s[11][j] &&
             by16 < s[12][j];
      }
      if (ok) {
        const float c0 = s[6][j], c1 = s[7][j], c2 = s[8][j];
        const float one_m_alpha = 1.0f - alpha;
        T = T / one_m_alpha;  // T before this slot blended
        ar0 = la * lc0 + (1.0f - la) * ar0;
        ar1 = la * lc1 + (1.0f - la) * ar1;
        ar2 = la * lc2 + (1.0f - la) * ar2;
        const float w = alpha * T;
        v[6] = w * g0;
        v[7] = w * g1;
        v[8] = w * g2;
        float dl_dalpha = T * ((c0 - ar0) * g0 + (c1 - ar1) * g1 +
                               (c2 - ar2) * g2);
        dl_dalpha = dl_dalpha - (fT / one_m_alpha) * bgg;
        la = alpha;
        lc0 = c0;
        lc1 = c1;
        lc2 = c2;
        const float dl_dG = op * dl_dalpha;
        const float gdx = G * dx, gdy = G * dy;
        v[0] = dl_dG * (-gdx * ca - gdy * cb);
        v[1] = dl_dG * (-gdy * cc - gdx * cb);
        v[2] = -0.5f * gdx * dx * dl_dG;
        v[3] = -gdx * dy * dl_dG;
        v[4] = -0.5f * gdy * dy * dl_dG;
        v[5] = G * dl_dalpha;
      }
#pragma unroll
      for (int i = 0; i < N_GRAD; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N_GRAD; ++i) part[warp][j][i] = v[i];
      }
    }
    __syncthreads();
    for (int o = tid; o < n * N_GRAD; o += n_threads) {
      const int j = o / N_GRAD, i = o % N_GRAD;
      float acc = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) acc = acc + part[wi][j][i];
      out[(size_t)(start + j) * N_GRAD + i] = acc;
    }
  }
}

}  // namespace

extern "C" int blend_bwd(const float* attrs, const int* gauss_index,
                         const int* k_hi, int T, int K,
                         int n_tx, int tile_h, int tile_w, int img_h,
                         int img_w, float origin_x, float origin_y,
                         int ref_gate, float alpha_min, float alpha_max,
                         const float* g_out, const float* bg_dot_g,
                         const float* final_T, const int* n_contrib,
                         float* grads, void* stream) {
  const int n_threads = tile_h * tile_w;
  if (n_threads % 32 != 0 || n_threads > 32 * MAX_WARPS) {
    return (int)cudaErrorInvalidValue;
  }
  blend_bwd_kernel<<<T, n_threads, 0, (cudaStream_t)stream>>>(
      attrs, gauss_index, k_hi, K, n_tx, tile_h, tile_w, img_h, img_w,
      origin_x, origin_y, ref_gate, alpha_min, alpha_max, g_out, bg_dot_g,
      final_T, n_contrib, grads);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
