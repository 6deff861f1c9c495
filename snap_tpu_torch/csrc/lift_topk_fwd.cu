// K1: fused top-k lift, forward (serving path).
//
// Replaces the per-rank loop of snap_tpu/ops/view_scan.py:pool_views_stream
// (rank_step) together with bilinear_patch_combine (_make_patch_combine),
// i.e. the 2x2xC patch gather that tools/pallas_gather_probe.py:
// patch_gather_pallas was written for, fused with the bilinear combine, the
// depth-hat score interpolation and the online-softmax pooling.
//
// Per point n and rank k (K ranks, in order):
//   pts   = clamp(p2d - 0.5, 0, (h, w) - 1); lower = floor(pts); frac = pts - lower
//   f     = sum over the 2x2 taps at (view*(h+1) + lower_i + a, lower_j + c)
//           of w_i[a] * w_j[c] * stack[...]                (all C channels, f32)
//   score = sum_s f[D + s] * max(0, 1 - |x(depth) - s|)   (S log-depth bins)
//   online softmax over the selected ranks: m, l, S1 = sum w f, S2 = sum w f^2
// Epilogue: stats = [S1/l, max(S2/l - mean^2, 0), m] (zeros where no rank is
// selected), written in the stack's dtype; valid = (count > 0).
//
// A rank that is not selected leaves the state exactly as the reference's
// masked update does (its weight is 0), so it is skipped without a read.
//
// Design: one warp per point; lanes split the C channels into 16-byte chunks
// (8 bf16 or 4 f32 values per load), CPL chunks per lane; the per-channel S1/S2
// and the scalar m/l live in registers across the K ranks; the score's dot
// product over the S bins is a warp shuffle reduction.
//
// What bounds it on an H100: bytes. At the flagship shape the stack is
// [1, 920, 61, 160] bf16 = 18 MB and stays in the 50 MB L2; the gathered
// traffic is 1.152M points x 4 ranks x 4 taps x 320 B = 5.9 GB, mostly L2
// hits. Device memory sees the per-rank inputs (~0.08 GB) and the bf16 stats
// written (1.152M x 257 x 2 B = 0.59 GB): ~0.2 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float from_float(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

template <typename T, int CPL>
__global__ void lift_topk_fwd_kernel(
    const T* __restrict__ stack,        // [B, R, W, C]
    const int32_t* __restrict__ view_idx,  // [B, N, K]
    const float* __restrict__ p2d,      // [B, N, K, 2] (row, col) pixels
    const uint8_t* __restrict__ selected,  // [B, N, K]
    const float* __restrict__ depth,    // [B, N, K]
    T* __restrict__ stats,              // [B, N, 2D + 1]
    uint8_t* __restrict__ valid,        // [B, N]
    int B, int N, int K, int R, int W, int C, int D, int h, int w,
    float depth_min, float depth_max, float log_range) {
  constexpr int E = Vec<T>::kElems;
  const int lane = threadIdx.x & 31;
  const long long point =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (point >= (long long)B * N) return;
  const int b = (int)(point / N);
  const int S = C - D;
  const int num_chunks = C / E;
  const T* base = stack + (long long)b * R * W * C;

  float s1[CPL][E], s2[CPL][E];
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
#pragma unroll
    for (int e = 0; e < E; ++e) { s1[q][e] = 0.f; s2[q][e] = 0.f; }
  }
  float m = kNegInf, l = 0.f;
  int count = 0;

  for (int k = 0; k < K; ++k) {
    const long long r = point * K + k;
    if (!selected[r]) continue;  // warp-uniform: one point per warp
    const int view = view_idx[r];
    const float pi = fminf(fmaxf(p2d[2 * r] - 0.5f, 0.f), (float)(h - 1));
    const float pj = fminf(fmaxf(p2d[2 * r + 1] - 0.5f, 0.f), (float)(w - 1));
    const float li = floorf(pi), lj = floorf(pj);
    const float fi = pi - li, fj = pj - lj;
    const int row0 = view * (h + 1) + (int)li;
    const int col0 = (int)lj;
    const float tap_w[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                            fi * (1.f - fj), fi * fj};
    const T* taps[4] = {
        base + ((long long)row0 * W + col0) * C,
        base + ((long long)row0 * W + col0 + 1) * C,
        base + ((long long)(row0 + 1) * W + col0) * C,
        base + ((long long)(row0 + 1) * W + col0 + 1) * C};

    // Depth-hat weights' abscissa: x in [0, S-1] over log-depth bins.
    const float d = fminf(fmaxf(depth[r], depth_min), depth_max);
    float x = logf(d / depth_min) / log_range * (float)(S - 1);
    x = fminf(fmaxf(x, 0.f), (float)(S - 1));

    float f[CPL][E];
    float partial = 0.f;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int chunk = lane + 32 * q;
#pragma unroll
      for (int e = 0; e < E; ++e) f[q][e] = 0.f;
      if (chunk < num_chunks) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v[E];
          Vec<T>::load(taps[t] + chunk * E, v);
#pragma unroll
          for (int e = 0; e < E; ++e) f[q][e] += tap_w[t] * v[e];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = chunk * E + e;
          if (c >= D) partial += f[q][e] * fmaxf(0.f, 1.f - fabsf(x - (float)(c - D)));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      partial += __shfl_xor_sync(0xffffffffu, partial, off);
    const float score = partial;

    // Online-softmax update of a selected rank (reference: rank_step).
    const float new_m = fmaxf(m, score);
    const float safe_m = new_m <= kNegInf ? 0.f : new_m;
    const float rescale = expf((m <= kNegInf ? kNegInf : m) - safe_m);
    const float wv = expf(score - safe_m);
    l = l * rescale + wv;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s1[q][e] = s1[q][e] * rescale + wv * f[q][e];
        s2[q][e] = s2[q][e] * rescale + wv * f[q][e] * f[q][e];
      }
    }
    m = new_m;
    ++count;
  }

  const bool ok = count > 0;
  const float l_safe = fmaxf(l, 1e-20f);
  T* out = stats + point * (2 * D + 1);
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int chunk = lane + 32 * q;
    if (chunk >= num_chunks) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = chunk * E + e;
      if (c < D) {
        const float mean = s1[q][e] / l_safe;
        const float var = fmaxf(s2[q][e] / l_safe - mean * mean, 0.f);
        out[c] = Vec<T>::from_float(ok ? mean : 0.f);
        out[D + c] = Vec<T>::from_float(ok ? var : 0.f);
      }
    }
  }
  if (lane == 0) {
    out[2 * D] = Vec<T>::from_float(ok ? m : 0.f);
    valid[point] = ok ? 1 : 0;
  }
}

template <typename T, int CPL>
void launch(const void* stack, const int32_t* view_idx, const float* p2d,
            const uint8_t* selected, const float* depth, void* stats,
            uint8_t* valid, int B, int N, int K, int R, int W, int C, int D,
            int h, int w, float depth_min, float depth_max,
            float log_range, cudaStream_t stream) {
  constexpr int kWarps = 8;
  const long long points = (long long)B * N;
  const unsigned blocks = (unsigned)((points + kWarps - 1) / kWarps);
  lift_topk_fwd_kernel<T, CPL><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(stack), view_idx, p2d, selected, depth,
      static_cast<T*>(stats), valid, B, N, K, R, W, C, D, h, w, depth_min,
      depth_max, log_range);
}

template <typename T>
int dispatch(const void* stack, const int32_t* view_idx, const float* p2d,
             const uint8_t* selected, const float* depth, void* stats,
             uint8_t* valid, int B, int N, int K, int R, int W, int C, int D,
             int h, int w, float depth_min, float depth_max,
             float log_range, cudaStream_t stream) {
  const int chunks = C / Vec<T>::kElems;
  const int cpl = (chunks + 31) / 32;
#define SNAP_LAUNCH(N_CPL)                                                    \
  launch<T, N_CPL>(stack, view_idx, p2d, selected, depth, stats, valid, B, N,   \
                   K, R, W, C, D, h, w, depth_min, depth_max, log_range,  \
                   stream)
  if (cpl <= 1) SNAP_LAUNCH(1);
  else if (cpl <= 2) SNAP_LAUNCH(2);
  else if (cpl <= 4) SNAP_LAUNCH(4);
  else return (int)cudaErrorInvalidValue;
#undef SNAP_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int lift_topk_fwd(
    const void* stack, const void* view_idx, const void* p2d,
    const void* selected, const void* depth, void* stats, void* valid,
    int dtype, int B, int N, int K, int R, int W, int C, int D, int h, int w,
    float depth_min, float depth_max, float log_range, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* idx = static_cast<const int32_t*>(view_idx);
  const auto* pts = static_cast<const float*>(p2d);
  const auto* sel = static_cast<const uint8_t*>(selected);
  const auto* dep = static_cast<const float*>(depth);
  auto* val = static_cast<uint8_t*>(valid);
  if (dtype == 0)
    return dispatch<float>(stack, idx, pts, sel, dep, stats, val, B, N, K, R,
                           W, C, D, h, w, depth_min, depth_max,
                           log_range, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(stack, idx, pts, sel, dep, stats, val, B,
                                   N, K, R, W, C, D, h, w, depth_min,
                                   depth_max, log_range, s);
  return (int)cudaErrorInvalidValue;
}
