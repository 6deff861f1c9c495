// K3: fused top-k lift, backward (training path).
//
// Replaces the backward of snap_tpu/ops/view_scan.py:pool_views_stream:
// XLA's autodiff of the per-rank online softmax (rank_step) followed by the
// custom VJP of bilinear_patch_combine (_make_patch_combine bwd, the
// scatter-add of the four weighted taps with duplicate indices, i.e. the
// transpose of the 2x2xC gather of tools/pallas_gather_probe.py:
// patch_gather_pallas).
//
// Forward (K1), per point over its K ranks: f_k = the bilinear combine of
// the C = D + S stack channels (features, then S log-depth score bins),
// z_k = sum_s f_k[D + s] hat_s(depth_k) if the rank is selected else -1e30,
// m = max z, p = softmax(z), mean = sum p f, E2 = sum p f^2,
// var = max(E2 - mean^2, 0), stats = [mean, var, m].
//
// Given g = d stats [B, N, 2D + 1] (zero where the point is invalid):
//   gE2 = g_var * tau, tau = 1 / 0.5 / 0 as E2 - mean^2 is > / == / < 0
//         (jnp.maximum's gradient at a tie: a single-view point has exactly
//         E2 - mean^2 = 0, so ties are common);
//   gmu = g_mean - 2 mean gE2;
//   d f_k = p_k (gmu + 2 gE2 f_k);  u_k = sum_c gmu f_k + gE2 f_k^2;
//   d z_k = p_k (u_k - sum_j p_j u_j) + the share of g_m that the chain
//           m = max(..max(max(-1e30, z_0), z_1).., z_{K-1}) passes to z_k,
//           an exact tie splitting it evenly (jnp.maximum's rule);
//   d c_k[s] = d z_k hat_s(depth_k);
// then w_tap * [d f_k, d c_k] is atomically added into an f32
// [B, R, W, C] buffer at each of the 4 taps of each selected rank. The
// wrapper casts the buffer to the stack's dtype. Coordinates, selection and
// depth get no gradient (the reference's VJP returns None for them).
//
// Design: one warp per point, in three passes over the point's ranks, so
// nothing of size K x C is kept:
//   1. recompute the forward exactly as K1 does (m, l, S1, S2 for the D
//      feature channels in registers, lanes over channels c = lane + 32 j);
//      lane k keeps z_k. The forward's m and l are recomputed here rather
//      than saved by K1: they would cost 8 B per point in each direction
//      (18 MB at the flagship shape) against one extra gather pass.
//   2. re-gather the D feature channels of each selected rank, reduce u_k
//      over the warp, scatter d f_k (coalesced: 32 lanes add to 32
//      consecutive floats of one tap);
//   3. scatter d c_k: the hat has at most two non-zero bins per rank.
// E2 - mean^2 is formed with round-to-nearest intrinsics (no FMA
// contraction), so a single-view point's tie is exactly 0 here as in the
// reference.
//
// Same-address atomics: consecutive points are consecutive z-levels of one
// column and project to nearly the same pixels. Warp w therefore takes
// point (w * stride) mod (B * N), with the stride coprime to B * N chosen by
// the wrapper near 0.618 (B * N): the warps in flight spread over the whole
// map instead of piling onto a few pixels.
//
// What bounds it on an H100: bytes. It reads the stack (L2-resident, 18 MB
// at the flagship shape [1, 920, 61, 160] bf16), the per-rank inputs
// (~0.1 GB) and g (1.152M x 257 x 2 B = 0.59 GB), and adds into the f32
// buffer (36 MB, L2-resident). The atomics (per selected rank, 4 taps x
// (D + 2) floats) are the expected limit in practice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Taps {
  long long offset[4];  // element offsets of the 4 taps' channel rows
  float weight[4];
  float x;              // depth-hat abscissa in [0, S - 1]
};

// The bilinear taps and depth-hat abscissa of one rank, as K1 forms them.
__device__ inline Taps rank_taps(int view, float p_i, float p_j, float dep,
                                 int W, int C, int h, int w, int S,
                                 float depth_min, float depth_max,
                                 float log_range) {
  Taps t;
  const float pi = fminf(fmaxf(p_i - 0.5f, 0.f), (float)(h - 1));
  const float pj = fminf(fmaxf(p_j - 0.5f, 0.f), (float)(w - 1));
  const float li = floorf(pi), lj = floorf(pj);
  const float fi = pi - li, fj = pj - lj;
  const long long row0 = (long long)view * (h + 1) + (long long)li;
  const long long col0 = (long long)lj;
  t.offset[0] = (row0 * W + col0) * C;
  t.offset[1] = (row0 * W + col0 + 1) * C;
  t.offset[2] = ((row0 + 1) * W + col0) * C;
  t.offset[3] = ((row0 + 1) * W + col0 + 1) * C;
  t.weight[0] = (1.f - fi) * (1.f - fj);
  t.weight[1] = (1.f - fi) * fj;
  t.weight[2] = fi * (1.f - fj);
  t.weight[3] = fi * fj;
  const float d = fminf(fmaxf(dep, depth_min), depth_max);
  const float x = logf(d / depth_min) / log_range * (float)(S - 1);
  t.x = fminf(fmaxf(x, 0.f), (float)(S - 1));
  return t;
}

__device__ inline float hat(float x, int s) {
  return fmaxf(0.f, 1.f - fabsf(x - (float)s));
}

template <typename T, int CPJ>
__global__ void lift_topk_bwd_kernel(
    const T* __restrict__ stack,           // [B, R, W, C]
    const int32_t* __restrict__ view_idx,  // [B, N, K]
    const float* __restrict__ p2d,         // [B, N, K, 2]
    const uint8_t* __restrict__ selected,  // [B, N, K]
    const float* __restrict__ depth,       // [B, N, K]
    const T* __restrict__ g_stats,         // [B, N, 2D + 1]
    float* __restrict__ grad,              // [B, R, W, C], zeroed
    int B, int N, int K, int R, int W, int C, int D, int h, int w,
    float depth_min, float depth_max, float log_range, long long stride) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)B * N;
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= total) return;
  const long long point = (warp * stride) % total;
  const int b = (int)(point / N);
  const int S = C - D;
  const T* base = stack + (long long)b * R * W * C;
  float* gbase = grad + (long long)b * R * W * C;
  const long long r0 = point * K;

  // Pass 1: the forward, as K1 computes it.
  float s1[CPJ], s2[CPJ];
#pragma unroll
  for (int j = 0; j < CPJ; ++j) { s1[j] = 0.f; s2[j] = 0.f; }
  float m = kNegInf, l = 0.f;
  float my_z = kNegInf;  // lane k: the score of rank k (-1e30 unselected)
  int count = 0;
  for (int k = 0; k < K; ++k) {
    const long long r = r0 + k;
    if (!selected[r]) continue;  // warp-uniform
    const Taps t = rank_taps(view_idx[r], p2d[2 * r], p2d[2 * r + 1],
                             depth[r], W, C, h, w, S, depth_min, depth_max,
                             log_range);
    float f[CPJ];
    float partial = 0.f;
#pragma unroll
    for (int j = 0; j < CPJ; ++j) {
      const int c = lane + 32 * j;
      f[j] = 0.f;
      if (c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[j] += t.weight[q] * to_float(base[t.offset[q] + c]);
        if (c >= D) partial += f[j] * hat(t.x, c - D);
      }
    }
    const float score = warp_sum(partial);
    if (lane == k) my_z = score;
    const float new_m = fmaxf(m, score);
    const float safe_m = new_m <= kNegInf ? 0.f : new_m;
    const float rescale = expf((m <= kNegInf ? kNegInf : m) - safe_m);
    const float wv = expf(score - safe_m);
    l = l * rescale + wv;
#pragma unroll
    for (int j = 0; j < CPJ; ++j) {
      s1[j] = s1[j] * rescale + wv * f[j];
      s2[j] = s2[j] * rescale + wv * f[j] * f[j];
    }
    m = new_m;
    ++count;
  }
  if (count == 0) return;  // invalid point: g is zero, nothing to add

  const float l_safe = fmaxf(l, 1e-20f);
  const T* g = g_stats + point * (2 * D + 1);
  float gmu[CPJ], ge2[CPJ];
#pragma unroll
  for (int j = 0; j < CPJ; ++j) {
    const int c = lane + 32 * j;
    gmu[j] = 0.f;
    ge2[j] = 0.f;
    if (c < D) {
      const float mean = __fdiv_rn(s1[j], l_safe);
      const float e2 = __fdiv_rn(s2[j], l_safe);
      const float var_raw = __fsub_rn(e2, __fmul_rn(mean, mean));
      const float tau = var_raw > 0.f ? 1.f : (var_raw == 0.f ? 0.5f : 0.f);
      ge2[j] = to_float(g[D + c]) * tau;
      gmu[j] = to_float(g[c]) - 2.f * mean * ge2[j];
    }
  }
  const float g_m = to_float(g[2 * D]);
  const bool my_sel = lane < K && selected[r0 + lane];
  const float my_p = my_sel ? expf(my_z - m) / l_safe : 0.f;

  // Pass 2: feature-channel gradients; lane k keeps u_k.
  float my_u = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long r = r0 + k;
    if (!selected[r]) continue;
    const Taps t = rank_taps(view_idx[r], p2d[2 * r], p2d[2 * r + 1],
                             depth[r], W, C, h, w, S, depth_min, depth_max,
                             log_range);
    const float p = __shfl_sync(kFull, my_p, k);
    float f[CPJ];
    float partial = 0.f;
#pragma unroll
    for (int j = 0; j < CPJ; ++j) {
      const int c = lane + 32 * j;
      f[j] = 0.f;
      if (c < D) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[j] += t.weight[q] * to_float(base[t.offset[q] + c]);
        partial += gmu[j] * f[j] + ge2[j] * f[j] * f[j];
      }
    }
    const float u = warp_sum(partial);
    if (lane == k) my_u = u;
#pragma unroll
    for (int j = 0; j < CPJ; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        const float df = p * (gmu[j] + 2.f * ge2[j] * f[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          atomicAdd(gbase + t.offset[q] + c, t.weight[q] * df);
      }
    }
  }

  // d z_k = p_k (u_k - sum_j p_j u_j) + the max chain's share of g_m.
  // Exclusive prefix max of z over the lanes (ranks) gives the running max
  // before each rank; an exclusive suffix product of the factors (0 past a
  // strict new max, 1/2 past a tie, 1 otherwise) gives what reaches it.
  const float sum_pu = warp_sum(my_p * my_u);
  const float z = lane < K ? my_z : kNegInf;
  float incl = z;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = fmaxf(incl, o);
  }
  float before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = kNegInf;
  const bool gt = lane < K && z > before;
  const bool eq = lane < K && z == before;
  const float factor = gt ? 0.f : (eq ? 0.5f : 1.f);
  float suffix = factor;  // inclusive suffix product
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(kFull, suffix, off);
    if (lane + off < 32) suffix *= o;
  }
  float after = __shfl_down_sync(kFull, suffix, 1);
  if (lane == 31) after = 1.f;
  const float share = g_m * after * (gt ? 1.f : (eq ? 0.5f : 0.f));
  const float my_dz = my_sel ? my_p * (my_u - sum_pu) + share : 0.f;

  // Pass 3: score-channel gradients, d c_k[s] = d z_k hat_s(depth_k).
  for (int k = 0; k < K; ++k) {
    const long long r = r0 + k;
    if (!selected[r]) continue;
    const float dz = __shfl_sync(kFull, my_dz, k);
    const Taps t = rank_taps(view_idx[r], p2d[2 * r], p2d[2 * r + 1],
                             depth[r], W, C, h, w, S, depth_min, depth_max,
                             log_range);
    for (int s = lane; s < S; s += 32) {
      const float hs = hat(t.x, s);
      if (hs > 0.f) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          atomicAdd(gbase + t.offset[q] + D + s, t.weight[q] * dz * hs);
      }
    }
  }
}

template <typename T, int CPJ>
void launch(const void* stack, const int32_t* view_idx, const float* p2d,
            const uint8_t* selected, const float* depth, const void* g_stats,
            float* grad, int B, int N, int K, int R, int W, int C, int D,
            int h, int w, float depth_min, float depth_max, float log_range,
            long long stride, cudaStream_t stream) {
  constexpr int kWarps = 8;
  const long long points = (long long)B * N;
  const unsigned blocks = (unsigned)((points + kWarps - 1) / kWarps);
  lift_topk_bwd_kernel<T, CPJ><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(stack), view_idx, p2d, selected, depth,
      static_cast<const T*>(g_stats), grad, B, N, K, R, W, C, D, h, w,
      depth_min, depth_max, log_range, stride);
}

template <typename T>
int dispatch(const void* stack, const int32_t* view_idx, const float* p2d,
             const uint8_t* selected, const float* depth, const void* g_stats,
             float* grad, int B, int N, int K, int R, int W, int C, int D,
             int h, int w, float depth_min, float depth_max, float log_range,
             long long stride, cudaStream_t stream) {
  if (K > 32) return (int)cudaErrorInvalidValue;  // one rank per lane
#define SNAP_LAUNCH(N_CPJ)                                                  \
  launch<T, N_CPJ>(stack, view_idx, p2d, selected, depth, g_stats, grad, B, \
                   N, K, R, W, C, D, h, w, depth_min, depth_max, log_range, \
                   stride, stream)
  const int cpj = (C + 31) / 32;
  if (cpj <= 2) SNAP_LAUNCH(2);
  else if (cpj <= 4) SNAP_LAUNCH(4);
  else if (cpj <= 5) SNAP_LAUNCH(5);
  else if (cpj <= 8) SNAP_LAUNCH(8);
  else return (int)cudaErrorInvalidValue;
#undef SNAP_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (stack and g_stats). grad is f32 and
// must be zeroed by the caller. Returns a cudaError_t (0 on success).
extern "C" int lift_topk_bwd(
    const void* stack, const void* view_idx, const void* p2d,
    const void* selected, const void* depth, const void* g_stats, void* grad,
    int dtype, int B, int N, int K, int R, int W, int C, int D, int h, int w,
    float depth_min, float depth_max, float log_range, long long stride,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* idx = static_cast<const int32_t*>(view_idx);
  const auto* pts = static_cast<const float*>(p2d);
  const auto* sel = static_cast<const uint8_t*>(selected);
  const auto* dep = static_cast<const float*>(depth);
  auto* out = static_cast<float*>(grad);
  if (dtype == 0)
    return dispatch<float>(stack, idx, pts, sel, dep, g_stats, out, B, N, K,
                           R, W, C, D, h, w, depth_min, depth_max, log_range,
                           stride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(stack, idx, pts, sel, dep, g_stats, out, B,
                                   N, K, R, W, C, D, h, w, depth_min,
                                   depth_max, log_range, stride, s);
  return (int)cudaErrorInvalidValue;
}
