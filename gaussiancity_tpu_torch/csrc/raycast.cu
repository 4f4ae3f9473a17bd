// Kernel V1: first-hit DDA raycast through an int32 id volume.
//
// Replaces the first-hit march of
// gaussiancity_tpu/ops/visibility.py::ray_voxel_intersection, which is an
// XLA while_loop (lockstep over all rays, bit-packed occupancy, a 1/4/16
// column hierarchy and survivor compaction) and has no Pallas kernel.
// Upstream ran the same traversal as CUDA
// (extensions/voxlib/ray_voxel_intersection.cu).
//
// Layout: one thread per ray, neighbouring threads on neighbouring pixels
// of one image row, so that coherent rays walk neighbouring voxels.  Each
// thread builds its ray from the shared basis (origin, up, side, fwd),
// applies the analytic sky skip (rays above ztop jump to ztop + 0.5;
// upward rays miss), then steps cell by cell: the next crossing is the
// smallest per-axis crossing parameter (lowest axis on ties), every
// crossing parameter is recomputed as (boundary - origin) / dir, and the
// first non-zero voxel entered is the hit.  The id volume [h, w, d] is
// read from global memory; nothing else is.
//
// What bounds it on an H100: the latency of the dependent voxel reads, one
// 4-byte load per step with ~20 fp32/int operations around it.  The bytes
// a frame needs (the voxels its rays visit) are a few MB and mostly hit
// L2; the operations are far below the fp32 peak.  The design keeps the
// per-ray work to exactly the cells the ray crosses (each ray exits at its
// hit, no lockstep) and relies on many resident threads to cover latency.
//
// Numerics: -fmad=false at build time and IEEE division / sqrt, so that
// the kernel and the plain version (ops/visibility.py::raycast_plain)
// produce the same hits and depths.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void raycast_kernel(const int* __restrict__ vol, int h, int w,
                               int d, const float* __restrict__ rays, int H,
                               int W, float cy, float cx, float f,
                               float ztop, int* __restrict__ voxel_id,
                               float* __restrict__ depth) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= H * W) return;
  const int py = r / W, px = r % W;
  const float ndc0 = cy - (float)py;
  const float ndc1 = (float)px - cx;
  float rd[3];
  #pragma unroll
  for (int i = 0; i < 3; ++i)
    rd[i] = rays[3 + i] * ndc0 + rays[6 + i] * ndc1 + rays[9 + i] * f;
  const float nrm = sqrtf(rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]);
  #pragma unroll
  for (int i = 0; i < 3; ++i) rd[i] = rd[i] / nrm;

  int id = 0;
  float dep = INFINITY;
  const float z_land = ztop + 0.5f;
  const bool above = rays[2] > z_land;
  if (!(above && rd[2] >= 0.0f)) {
    float t_skip = (above && rd[2] < 0.0f) ? (z_land - rays[2]) / rd[2]
                                           : 0.0f;
    t_skip = fmaxf(t_skip, 0.0f);
    const int dims[3] = {h, w, d};
    float o[3], inv[3], tm[3];
    int c[3];
    #pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[i] = rays[i] + t_skip * rd[i];
      c[i] = (int)floorf(o[i]);
      inv[i] = 1.0f / rd[i];
      tm[i] = rd[i] == 0.0f
                  ? INFINITY
                  : ((float)(c[i] + (rd[i] > 0.0f ? 1 : 0)) - o[i]) * inv[i];
    }
    while (true) {
      const int a =
          (tm[0] <= tm[1] && tm[0] <= tm[2]) ? 0 : (tm[1] <= tm[2] ? 1 : 2);
      const float t = tm[a];
      const int step = rd[a] > 0.0f ? 1 : -1;
      c[a] += step;
      if ((step > 0 && c[a] >= dims[a]) || (step < 0 && c[a] < 0)) break;
      tm[a] = ((float)(c[a] + (step > 0 ? 1 : 0)) - o[a]) * inv[a];
      if (c[0] >= 0 && c[0] < h && c[1] >= 0 && c[1] < w && c[2] >= 0 &&
          c[2] < d) {
        const int v = vol[((size_t)c[0] * w + c[1]) * d + c[2]];
        if (v != 0) {
          id = v;
          dep = t + t_skip;
          break;
        }
      }
    }
  }
  voxel_id[r] = id;
  depth[r] = dep;
}

}  // namespace

extern "C" int raycast(const int* vol, int h, int w, int d,
                       const float* rays, int H, int W, float cy, float cx,
                       float f, float ztop, int* voxel_id, float* depth,
                       void* stream) {
  const int threads = 128;
  const int blocks = (H * W + threads - 1) / threads;
  if (blocks > 0)
    raycast_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        vol, h, w, d, rays, H, W, cy, cx, f, ztop, voxel_id, depth);
  return (int)cudaGetLastError();
}

extern "C" const char* raycast_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
