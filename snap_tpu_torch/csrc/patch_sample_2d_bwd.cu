// K4: backward of the bilinear 2x2 patch sampler (K2).
//
// Replaces the custom VJP of snap_tpu/ops/view_scan.py:gather_bilinear_patches
// (_make_patch_gather bwd: the flat-row scatter-add of the 2x2 patch
// cotangent, the transpose of the 2x2xC gather of
// tools/pallas_gather_probe.py:patch_gather_pallas) together with the
// transpose of interpolate_patch_2d's bilinear combine. The exhaustive pose
// backend's templates send their gradient through it to the query BEV.
//
// Input: g = d values [B, P, D] in the plane's dtype and the points
// [B, P, 2] f32, as K2 took them. Per point, with K2's clamped taps and
// weights (the same f32 coordinates), w_tap * g is atomically added into
// an f32 [B, H+1, W+1, C] buffer at each of the 4 taps, for every point,
// valid or not: the caller's where() has already zeroed g where the sample
// is invalid. The validity channel (C = D + 1) gets nothing. The wrapper
// casts the buffer to the plane's dtype; the caller's edge padding folds
// the pad row and column back onto the edge.
//
// Design: one warp per point, lanes over the D channels, so each of the 4
// taps is one coalesced run of atomics (32 consecutive floats at D = 32).
// The points of one template are neighbouring cells and the templates of
// all rotations cover the same plane, so consecutive points hit the same
// cells: warp w takes point (w * stride) mod (B * P), with the stride
// coprime to B * P chosen by the wrapper near 0.618 (B * P), which spreads
// the warps in flight over the plane.
//
// What bounds it on an H100: bytes. The plane buffer is tiny ([121, 81, 33]
// f32, 1.3 MB, L2-resident); device memory sees the points (8 B each) and g
// (2D bytes each): 614,400 coarse points move ~44 MB, ~13 us at 3.35 TB/s.
// The 4 x 32 atomics per point into ~320k addresses are the expected limit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void patch_sample_2d_bwd_kernel(
    const T* __restrict__ g_values,    // [B, P, D]
    const float* __restrict__ points,  // [B, P, 2]
    float* __restrict__ grad,          // [B, H+1, W+1, C], zeroed
    int B, int P, int H, int W, int C, int D, long long stride) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)B * P;
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= total) return;
  const long long point = (warp * stride) % total;
  const int b = (int)(point / P);
  const int Wp = W + 1;

  // K2's coordinates: clamp, floor, and the low-edge collapse (a point in
  // [0, 0.5) clamps to 0 and gives the upper tap weight 0).
  float pi = points[2 * point] - 0.5f, pj = points[2 * point + 1] - 0.5f;
  pi = fminf(fmaxf(pi, 0.f), (float)(H - 1));
  pj = fminf(fmaxf(pj, 0.f), (float)(W - 1));
  const int li = min((int)floorf(pi), H - 1);
  const int lj = min((int)floorf(pj), W - 1);
  const float fi = pi - (float)li, fj = pj - (float)lj;
  const float tap_w[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                          fi * (1.f - fj), fi * fj};
  float* base = grad + (long long)b * (H + 1) * Wp * C;
  float* taps[4] = {base + ((long long)li * Wp + lj) * C,
                    base + ((long long)li * Wp + lj + 1) * C,
                    base + ((long long)(li + 1) * Wp + lj) * C,
                    base + ((long long)(li + 1) * Wp + lj + 1) * C};

  const T* g = g_values + point * D;
  for (int c = lane; c < D; c += 32) {
    const float gv = to_float(g[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) atomicAdd(taps[t] + c, tap_w[t] * gv);
  }
}

template <typename T>
int launch(const void* g_values, const float* points, float* grad, int B,
           int P, int H, int W, int C, int D, long long stride,
           cudaStream_t stream) {
  constexpr int kWarps = 8;
  const long long n = (long long)B * P;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  launches.add(patch_sample_2d_bwd_kernel<T>, "patch_sample_2d_bwd_kernel",
               kWarps * 32, 0);
  patch_sample_2d_bwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(g_values), points, grad, B, P, H, W, C, D,
      stride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g_values). grad is f32 and must be
// zeroed by the caller. Returns a cudaError_t (0 on success).
extern "C" int patch_sample_2d_bwd(const void* g_values, const void* points,
                                   void* grad, int dtype, int B, int P, int H,
                                   int W, int C, int D, long long stride,
                                   void* stream) {
  launches.clear();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pts = static_cast<const float*>(points);
  auto* out = static_cast<float*>(grad);
  if (dtype == 0)
    return launch<float>(g_values, pts, out, B, P, H, W, C, D, stride, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g_values, pts, out, B, P, H, W, C, D, stride,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int patch_sample_2d_bwd_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
