// K2: bilinear 2x2 patch sampler of a 2-D feature plane, in f32, bf16 or
// f16 (the sums in f32, rounded once to the plane's dtype).
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
// Design, in two launches from one call:
//   1. pack: the plane's rows of C = D + 1 values (66 bytes at D = 32 bf16,
//      so no tap row is 16-byte aligned) are copied into rows of Dp values,
//      D rounded up to 16 bytes (8 bf16 or 4 f32; the tail is zero), and
//      the validity channel into a uint8 plane [B, H+1, W+1]. The plane is
//      small (121 x 81 pixels at the flagship shape, 0.65 MB): this costs
//      one short launch, counted in K2's time. The caller's layout stays as
//      it is, so K4, the plain versions and interpolate_patch_2d are
//      untouched.
//   2. sample: one thread per (point, 16-byte chunk of Dp): at D = 32 bf16,
//      four threads per point and eight points per warp. Each thread makes
//      one 8-byte load of its point, four independent 16-byte tap loads,
//      accumulates in f32 and makes one 16-byte store (a D that is not a
//      multiple of the chunk stores its tail one value at a time); the
//      chunk-0 thread reads the consulted taps' validity bytes and writes
//      valid. A grid-stride loop over as many blocks as the card keeps
//      resident holds many independent loads in flight on every SM.
//
// What bounds it on an H100: bytes. The plane stays in L2; device memory
// sees the points (8 B each), the values written (2D bytes each) and the
// valid bytes: 614,400 coarse points at D = 32 bf16 move ~45 MB, ~13.6 us
// at 3.35 TB/s. The design before this one (one warp per point, 2-byte lane
// loads, lane 0 reading the validity serially) was latency-bound at 16.5x
// that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

constexpr int kThreads = 256;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ inline float to_float(__half x) { return __half2float(x); }
__device__ inline void store(__half* p, float x) { *p = __float2half_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) pack_plane_kernel(
    const T* __restrict__ padded,  // [B, H+1, W+1, C]
    T* __restrict__ feats,         // [B, H+1, W+1, Dp]
    uint8_t* __restrict__ valid_plane,  // [B, H+1, W+1]
    long long pixels, int C, int D, int Dp, int has_valid) {
  const long long n = pixels * Dp;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i / Dp;
    const int c = (int)(i - pix * Dp);
    store(feats + i, c < D ? to_float(padded[pix * C + c]) : 0.f);
    if (c == 0)
      valid_plane[pix] =
          has_valid ? (to_float(padded[pix * C + D]) > 0.5f ? 1 : 0) : 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) patch_sample_2d_kernel(
    const T* __restrict__ feats,            // [B, H+1, W+1, Dp]
    const uint8_t* __restrict__ valid_plane,  // [B, H+1, W+1]
    const float2* __restrict__ points,      // [B, P] of (row, col)
    T* __restrict__ values,                 // [B, P, D]
    uint8_t* __restrict__ valid,            // [B, P]
    int B, int P, int H, int W, int D, int Dp, int has_valid) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte chunk
  const int Q = Dp / E;              // chunks per point
  const int Wp = W + 1;
  const bool vec_out = D == Dp;
  const unsigned total = (unsigned)B * P * Q;
  const uint4* rows = reinterpret_cast<const uint4*>(feats);
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += gridDim.x * blockDim.x) {
    const unsigned point = t / Q;
    const int chunk = (int)(t - point * Q);
    const int b = (int)(point / P);
    const float2 pt = points[point];
    const bool in_bounds =
        pt.x >= 0.f && pt.x < (float)H && pt.y >= 0.f && pt.y < (float)W;
    float pi = pt.x - 0.5f, pj = pt.y - 0.5f;
    const bool count_i = pi >= 0.f, count_j = pj >= 0.f;
    pi = fminf(fmaxf(pi, 0.f), (float)(H - 1));
    pj = fminf(fmaxf(pj, 0.f), (float)(W - 1));
    const int li = min((int)floorf(pi), H - 1);
    const int lj = min((int)floorf(pj), W - 1);
    const float fi = pi - (float)li, fj = pj - (float)lj;
    const float tap_w[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                            fi * (1.f - fj), fi * fj};
    const long long pix0 = ((long long)b * (H + 1) + li) * Wp + lj;
    const long long pix[4] = {pix0, pix0 + 1, pix0 + Wp, pix0 + Wp + 1};

    uint4 tap[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) tap[q] = __ldg(rows + pix[q] * Q + chunk);
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T* v = reinterpret_cast<const T*>(&tap[q]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += tap_w[q] * to_float(v[e]);
    }

    const int c0 = chunk * E;
    T* out = values + (long long)point * D + c0;
    if (vec_out) {
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < E; ++e) store(o + e, acc[e]);
      *reinterpret_cast<uint4*>(out) = packed;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (c0 + e < D) store(out + e, acc[e]);
    }
    if (chunk == 0) {
      bool ok = in_bounds;
      if (has_valid) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool consulted =
              (count_i || q < 2) && (count_j || (q & 1) == 0);
          if (consulted && !valid_plane[pix[q]]) ok = false;
        }
      }
      valid[point] = ok ? 1 : 0;
    }
  }
}

// Blocks for a grid-stride kernel: as many as the card keeps resident, and
// no more than the work needs.
template <typename Kernel>
unsigned resident_blocks(Kernel kernel, long long work) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long needed = (work + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(needed < resident ? (needed > 0 ? needed : 1) : resident);
}

template <typename T>
int launch(const void* padded, void* feats, uint8_t* valid_plane,
           const float* points, void* values, uint8_t* valid, int B, int P,
           int H, int W, int C, int D, int Dp, int has_valid,
           cudaStream_t stream) {
  const long long pixels = (long long)B * (H + 1) * (W + 1);
  launches.add(pack_plane_kernel<T>, "pack_plane_kernel", kThreads, 0);
  pack_plane_kernel<T><<<resident_blocks(pack_plane_kernel<T>, pixels * Dp),
                         kThreads, 0, stream>>>(
      static_cast<const T*>(padded), static_cast<T*>(feats), valid_plane,
      pixels, C, D, Dp, has_valid);
  int code = (int)cudaGetLastError();
  if (code) return code;
  const long long work = (long long)B * P * (Dp / (16 / (int)sizeof(T)));
  launches.add(patch_sample_2d_kernel<T>, "patch_sample_2d_kernel", kThreads,
               0);
  patch_sample_2d_kernel<T><<<resident_blocks(patch_sample_2d_kernel<T>,
                                              work),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(feats), valid_plane,
      reinterpret_cast<const float2*>(points), static_cast<T*>(values), valid,
      B, P, H, W, D, Dp, has_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. feats [B, H+1, W+1, Dp] (Dp =
// D rounded up to 16 bytes) and valid_plane [B, H+1, W+1] uint8 are scratch the
// caller allocates; points must be 8-byte aligned and B * P * Dp * dtype size /
// 16 below 2^31. Returns a cudaError_t (0 on success).
extern "C" int patch_sample_2d(const void* padded, void* feats,
                               void* valid_plane, const void* points,
                               void* values, void* valid, int dtype, int B,
                               int P, int H, int W, int C, int D, int Dp,
                               int has_valid, void* stream) {
  launches.clear();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pts = static_cast<const float*>(points);
  auto* vplane = static_cast<uint8_t*>(valid_plane);
  auto* val = static_cast<uint8_t*>(valid);
  if (dtype == 0)
    return launch<float>(padded, feats, vplane, pts, values, val, B, P, H, W,
                         C, D, Dp, has_valid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(padded, feats, vplane, pts, values, val, B, P,
                                 H, W, C, D, Dp, has_valid, s);
  if (dtype == 2)
    return launch<__half>(padded, feats, vplane, pts, values, val, B, P, H, W,
                          C, D, Dp, has_valid, s);
  return (int)cudaErrorInvalidValue;
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int patch_sample_2d_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
