// K2: bilinear 2x2 patch sampler of a 2-D feature plane.
//
// Replaces the patch gather of snap_tpu/ops/view_scan.py:interpolate_patch_2d
// (_make_patch_gather via gather_bilinear_patches, i.e. the 2x2xC gather of
// tools/pallas_gather_probe.py:patch_gather_pallas) with its bilinear
// weights and its validity rule fused in. The exhaustive pose backend calls
// it to warp the query BEV into rotated templates (64 coarse and 41 fine
// angles at the flagship shape).
//
// Input: the edge-padded plane [B, H+1, W+1, C], C = D features plus, when
// has_valid, one validity channel (1.0 / 0.0), and points [B, P, 2] in grid
// coordinates (cell centers at half-integers). Per point, as the reference:
//   in_bounds = 0 <= p < (H, W)
//   pts = p - 0.5; count_upper = pts >= 0   (else both taps collapse on 0)
//   pts = clamp(pts, 0, (H, W) - 1); lower = min(floor(pts), (H, W) - 1)
//   values = sum over taps (a, c) of w_i[a] w_j[c] padded[lower + (a, c), :D]
//   valid = in_bounds and, if has_valid, every *consulted* tap is valid: tap
//           (a, c) is consulted iff (count_upper_i or a == 0) and
//           (count_upper_j or c == 0).
// The kernel applies this validity rule itself and writes valid [B, P].
// The coordinates are f32 whatever the plane's dtype.
//
// Design: one warp per point, lanes over the D channels (coalesced reads of
// each tap's row of channels), f32 accumulation, output in the plane dtype.
//
// What bounds it on an H100: bytes. The plane is tiny ([121, 81, 33] bf16,
// 0.65 MB, L2-resident); device memory sees the points (8 B each) and the
// values written (2D bytes each): 614,400 coarse points move ~45 MB, ~13 us
// at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void patch_sample_2d_kernel(
    const T* __restrict__ padded,     // [B, H+1, W+1, C]
    const float* __restrict__ points,  // [B, P, 2]
    T* __restrict__ values,            // [B, P, D]
    uint8_t* __restrict__ valid,       // [B, P]
    int B, int P, int H, int W, int C, int D, int has_valid) {
  const int lane = threadIdx.x & 31;
  const long long point =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (point >= (long long)B * P) return;
  const int b = (int)(point / P);
  const int Wp = W + 1;

  const float y = points[2 * point], x = points[2 * point + 1];
  const bool in_bounds = y >= 0.f && y < (float)H && x >= 0.f && x < (float)W;
  float pi = y - 0.5f, pj = x - 0.5f;
  const bool count_i = pi >= 0.f, count_j = pj >= 0.f;
  pi = fminf(fmaxf(pi, 0.f), (float)(H - 1));
  pj = fminf(fmaxf(pj, 0.f), (float)(W - 1));
  const int li = min((int)floorf(pi), H - 1);
  const int lj = min((int)floorf(pj), W - 1);
  const float fi = pi - (float)li, fj = pj - (float)lj;
  const float tap_w[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                          fi * (1.f - fj), fi * fj};
  const T* base = padded + (long long)b * (H + 1) * Wp * C;
  const T* taps[4] = {base + ((long long)li * Wp + lj) * C,
                      base + ((long long)li * Wp + lj + 1) * C,
                      base + ((long long)(li + 1) * Wp + lj) * C,
                      base + ((long long)(li + 1) * Wp + lj + 1) * C};

  T* out = values + point * D;
  for (int c = lane; c < D; c += 32) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) acc += tap_w[t] * to_float(taps[t][c]);
    store(out + c, acc);
  }
  if (lane == 0) {
    bool ok = in_bounds;
    if (has_valid) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool consulted = (count_i || t < 2) && (count_j || (t & 1) == 0);
        if (consulted && !(to_float(taps[t][D]) > 0.5f)) ok = false;
      }
    }
    valid[point] = ok ? 1 : 0;
  }
}

template <typename T>
int launch(const void* padded, const float* points, void* values,
           uint8_t* valid, int B, int P, int H, int W, int C, int D,
           int has_valid, cudaStream_t stream) {
  constexpr int kWarps = 8;
  const long long n = (long long)B * P;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  patch_sample_2d_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(padded), points, static_cast<T*>(values), valid,
      B, P, H, W, C, D, has_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int patch_sample_2d(const void* padded, const void* points,
                               void* values, void* valid, int dtype, int B,
                               int P, int H, int W, int C, int D,
                               int has_valid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pts = static_cast<const float*>(points);
  auto* val = static_cast<uint8_t*>(valid);
  if (dtype == 0)
    return launch<float>(padded, pts, values, val, B, P, H, W, C, D,
                         has_valid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(padded, pts, values, val, B, P, H, W, C, D,
                                 has_valid, s);
  return (int)cudaErrorInvalidValue;
}
