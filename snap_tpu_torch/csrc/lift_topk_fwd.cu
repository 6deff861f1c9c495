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
//           (the score bins, and the features of the layouts with the
//           max and min, in tap_add's order, lift_stats.cuh: taps (0,0),
//           (0,1), (1,0), (1,1), each product rounded, added left to
//           right; the other layouts' features with fused products)
//   score = sum_s f[D + s] * max(0, 1 - |x(depth) - s|)   (S log-depth bins)
//   online softmax over the selected ranks: m, l, S1 = sum w f, S2 = sum w f^2
// Epilogue: stats = [S1/l, max(S2/l - mean^2, 0), m] (zeros where no rank is
// selected), written in the stack's dtype; valid = (count > 0).
//
// B8, the other statistics layouts (lift_stats.cuh), each a compile-time
// mode of its own: unweighted (C = D: every selected rank scores 0, so the
// weights are equal and no m is written), without the variance, and with
// the max and min of each feature channel over the selected ranks, in the
// row [mean, var?, max?, min?, m?]. Any K <= 32 (the scan form's K = V =
// 20) and D <= 256.
//
// A rank that is not selected leaves the state exactly as the reference's
// masked update does (its weight is 0), so it is skipped without a read.
// The flagship's layout walks ranks 0..K-1 and skips those (the design
// below). B8's layouts visit the selected ones alone (lift_point_compact):
// a point's n selected ranks are compacted in rank order (a ballot; lane
// j < n takes the j-th, as K3's ranks stage does), so an unselected rank
// costs no shuffle, tap weight, zeroed tap or FMA (the scan selects ~3.7
// of its 20). A point with n <= 4 / CPL (nearly all: the stream's K = 4,
// the scan's top 4 but for ties at its threshold) takes one group whose
// loop is known at compile time; one with more, a runtime loop over its
// compacted ranks, in the same kernel (K1 has no second pass whose
// registers a wide branch would raise, unlike K3). The unweighted layouts
// read no depth and form no score. The flagship's layout through
// lift_point_compact gave the same stats but took 1.3% longer in bf16 and
// 4.2% in f32 on an H100, so it keeps its own loop.
//
// What bounds it on an H100: bytes. At the serving shape the stack is
// [1, 920, 61, 160] bf16 = 18 MB and stays in the 50 MB L2; device memory
// sees the per-rank inputs (~0.08 GB) and the stats written (1.152M x 257 x
// 2 B = 0.59 GB): ~0.2 ms at 3.35 TB/s. On the RANSAC path (f32, batch 4)
// the stats are 4.6M x 1,028 B = 4.7 GB, ~1.4 ms. What holds it back is
// L2 and instruction issue: a selected rank reads 4 taps x (the D feature
// channels + the sector or two of its two depth bins), ~4.7 GB of 32-byte
// sectors at the serving input (4.05M selected ranks; the first design
// read all C channels, 5.2 GB), and a point is ~1,100 SASS instructions
// (the static count of its loop; at 4 warp-instructions per clock and SM
// that alone is ~1.4 ms for 1.152M points).
//
// Design (K3's rank stage, csrc/lift_topk_bwd.cu): a warp per point.
//   - Lane l holds feature channels 4 (l + 32 q) .. + 3, q < CPL (D % 4 ==
//     0, D <= 128 CPL): all 32 lanes busy at D = 128, 8-byte loads in bf16
//     and 16-byte loads in f32.
//   - Lanes 0..K-1 load their rank's inputs once; the others get them by
//     shuffles. Lane k forms score z_k from the two depth bins whose hat is
//     non-zero (the other bins' terms are exact zeros).
//   - Every tap of a group of ranks is loaded before any is used (groups of
//     4 / CPL ranks, so the raw taps take a fixed 16 registers of loads);
//     with K <= 4 / CPL (every configuration) the group loop is unrolled at
//     compile time. A point costs two dependent memory round trips (its
//     ranks' inputs, then all taps) instead of two per rank.
//   - The online softmax runs in rank order, as the reference and K3 do:
//     the variance's tie rule (C7) makes the rounding of E2 - mean^2 matter.
//   - A warp walks kPointsPerWarp consecutive points (on the map lift, the
//     z levels of a column, whose taps overlap in L1), loading the next
//     point's rank inputs while it computes the current one. Their stats
//     rows (514 B in bf16, 1,028 B in f32, mostly off a 16-byte boundary)
//     form one contiguous span: each row is staged in the warp's shared
//     memory behind the partial 16-byte chunk carried from the row before,
//     and written as 16-byte stores, scalar stores only for the span's two
//     end chunks. No block-wide barrier: warps run independently. A block
//     per 8 points with a block-wide staged write took 1.42 ms (bf16) and
//     7.4 ms (f32) at the serving and RANSAC paths' inputs on an H100;
//     this design 1.37 and 5.4 (1.28 and 4.95 with S1 and S2 times one
//     reciprocal per point, given up: a quotient an ulp off the plain
//     version's can put the variance on the other side of its tie at 0
//     from K3's).
//   - Launch bounds keep f32 within 128 registers and bf16 within 80 (2 and
//     3 blocks per SM): a build a few registers over lost a block per SM
//     and a third of its speed on an H100. f16 has bf16's width and takes
//     its bound; both accumulate in f32 and round the stats once, f16's
//     past 65504 to inf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <stdint.h>

#include "launch_log.cuh"
#include "lift_stats.cuh"

namespace {

LaunchLog launches;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
// Consecutive points per warp, and the blocks per SM that ptxas must fit
// in registers, by dtype: a kernel a few registers over 128 (f32) or 80
// (bf16, f16) loses a block per SM, and a third of its speed with it.
constexpr int kPointsPerWarp = 16;
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 3 : 2;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void from_float(float x, float* out) { *out = x; }
__device__ inline void from_float(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}
__device__ inline float to_float(__half x) { return __half2float(x); }
// Round to nearest; a value past 65504 becomes inf, as a cast of the f32
// sum to float16 does.
__device__ inline void from_float(float x, __half* out) {
  *out = __float2half_rn(x);
}

// 4 channels: loaded raw, converted later.
template <typename T> struct Quad;

template <> struct Quad<float> {
  using Raw = uint4;
  __device__ static Raw load(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void convert(const Raw& v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
};

template <> struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static void convert(const Raw& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

template <> struct Quad<__half> {
  using Raw = uint2;
  __device__ static Raw load(const __half* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static void convert(const Raw& v, float* out) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

__device__ inline float hat(float x, int s) {
  return fmaxf(0.f, 1.f - fabsf(x - (float)s));
}

struct Dims {
  int B, N, K, R, W, C, D, h, w;
  float depth_min, depth_max, log_range;
};

// Elements of a warp's staging buffer: a row after a carried partial
// chunk, rounded up to whole 16-byte chunks.
template <typename T> __host__ __device__ constexpr int staged_stride(int row) {
  return (row + 2 * (16 / (int)sizeof(T)) - 2) / (16 / (int)sizeof(T)) *
         (16 / (int)sizeof(T));
}

// Lane k < K: rank k of a point, as loaded.
struct RankIn {
  bool sel;
  int view;
  float pi, pj, dep;
};

// kDepth: the layout scores its ranks by depth (weighted); else depth is
// not read.
template <bool kDepth>
__device__ inline RankIn load_ranks(long long point, int lane, const Dims& d,
                                    const int32_t* view_idx, const float* p2d,
                                    const uint8_t* selected,
                                    const float* depth) {
  RankIn in{false, 0, 0.f, 0.f, 0.f};
  if (lane < d.K) {
    const long long r = point * d.K + lane;
    in.sel = selected[r];
    in.view = view_idx[r];
    in.pi = p2d[2 * r];
    in.pj = p2d[2 * r + 1];
    if constexpr (kDepth) in.dep = depth[r];
  }
  return in;
}

// The position of the (j + 1)-th set bit of mask, j < __popc(mask).
__device__ inline int nth_set_bit(unsigned mask, int j) {
  for (int i = 0; i < j; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// A point's stats row from its pooled sums into my_row, and its valid
// flag (ok: some rank selected). mean, E2 and E2 - mean^2 rounded as the
// plain version and K3 round them (correctly rounded quotients, no FMA):
// the variance's tie at 0 falls on the same side in all three.
// fmx and fmn (the max and min) are read only where the layout has them.
template <typename T, int CPL, int kMode>
__device__ inline void write_stats(const float (&s1a)[CPL][4],
                                   const float (&s2a)[CPL][4],
                                   const float (*fmx)[4], const float (*fmn)[4],
                                   float m, float l, bool ok, int lane, int D,
                                   T* my_row, uint8_t* valid) {
  const float l_safe = fmaxf(l, 1e-20f);
  const int at_max = max_offset(kMode, D);
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int c0 = 4 * (lane + 32 * q);
    if (c0 >= D) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mean = __fdiv_rn(s1a[q][e], l_safe);
      from_float(ok ? mean : 0.f, my_row + c0 + e);
      if constexpr ((kMode & kVariance) != 0) {
        const float e2 = __fdiv_rn(s2a[q][e], l_safe);
        const float var = fmaxf(__fsub_rn(e2, __fmul_rn(mean, mean)), 0.f);
        from_float(ok ? var : 0.f, my_row + D + c0 + e);
      }
      if constexpr ((kMode & kMinMax) != 0) {
        from_float(ok ? fmx[q][e] : 0.f, my_row + at_max + c0 + e);
        from_float(ok ? fmn[q][e] : 0.f, my_row + at_max + D + c0 + e);
      }
    }
  }
  if (lane == 0) {
    if constexpr ((kMode & kWeighted) != 0)
      from_float(ok ? m : 0.f, my_row + stats_width(kMode, D) - 1);
    *valid = ok ? 1 : 0;
  }
}

// The flagship's layout: one point's stats row into my_row (shared
// memory) and its valid flag, walking ranks 0..K-1.
template <typename T, int CPL, bool kOneGroup>
__device__ inline void lift_point(const T* __restrict__ stack,
                                  const RankIn& in, long long point, int lane,
                                  const Dims& d, T* my_row, uint8_t* valid) {
  constexpr int KG = 4 / CPL;  // ranks per group
  using Raw = typename Quad<T>::Raw;
  const int C = d.C, D = d.D, S = C - D, W = d.W;
  const int b = (int)(point / d.N);
  const T* base = stack + (long long)b * d.R * W * C;
  const long long down = (long long)W * C;

  // Lane k < K: rank k's geometry and first tap.
  bool sel = false;
  float fi = 0.f, fj = 0.f, x = 0.f;
  long long tap0 = 0;
  if (lane < d.K) {
    const int view = in.view;
    const float dep = in.dep;
    if (in.sel) {
      sel = true;
      const float pi = fminf(fmaxf(in.pi - 0.5f, 0.f), (float)(d.h - 1));
      const float pj = fminf(fmaxf(in.pj - 0.5f, 0.f), (float)(d.w - 1));
      const float li = floorf(pi), lj = floorf(pj);
      fi = pi - li;
      fj = pj - lj;
      tap0 = (((long long)view * (d.h + 1) + (int)li) * W + (int)lj) * C;
      const float dc = fminf(fmaxf(dep, d.depth_min), d.depth_max);
      const float xr = logf(dc / d.depth_min) / d.log_range * (float)(S - 1);
      x = fminf(fmaxf(xr, 0.f), (float)(S - 1));
    }
  }
  const unsigned selmask = __ballot_sync(kFull, sel);

  // Lane k: score z_k from the two depth bins around x (loads issued
  // here, used after the first group's taps are in flight).
  float za[4], zb[4];
  const int s0 = min((int)x, S - 1), s1 = min(s0 + 1, S - 1);
  if (sel) {
    const T* taps[4] = {base + tap0, base + tap0 + C, base + tap0 + down,
                        base + tap0 + down + C};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      za[t] = to_float(taps[t][D + s0]);
      zb[t] = to_float(taps[t][D + s1]);
    }
  }

  float f[KG][CPL][4];
  auto gather = [&](int k0) {
    Raw raw[KG][CPL][4];
    float tw[KG][4];
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int k = k0 + u;
      const long long off = __shfl_sync(kFull, tap0, k & 31);
      const float gi = __shfl_sync(kFull, fi, k & 31);
      const float gj = __shfl_sync(kFull, fj, k & 31);
      tw[u][0] = (1.f - gi) * (1.f - gj);
      tw[u][1] = (1.f - gi) * gj;
      tw[u][2] = gi * (1.f - gj);
      tw[u][3] = gi * gj;
      const bool on = k < 32 && ((selmask >> k) & 1);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c0 = 4 * (lane + 32 * q);
        if (on && c0 < D) {
          const T* p = base + off + c0;
          raw[u][q][0] = Quad<T>::load(p);
          raw[u][q][1] = Quad<T>::load(p + C);
          raw[u][q][2] = Quad<T>::load(p + down);
          raw[u][q][3] = Quad<T>::load(p + down + C);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) raw[u][q][t] = Raw{};
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KG; ++u)
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[u][q][e] = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v[4];
          Quad<T>::convert(raw[u][q][t], v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[u][q][e] = feature_tap_add(false, f[u][q][e], tw[u][t], v[e], t);
        }
      }
  };

  float s1a[CPL][4], s2a[CPL][4];
#pragma unroll
  for (int q = 0; q < CPL; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1a[q][e] = 0.f;
      s2a[q][e] = 0.f;
    }
  float m = kNegInf, l = 0.f;
  float my_z = kNegInf;
  const int num_k = kOneGroup ? KG : d.K;
  for (int k0 = 0; k0 < num_k; k0 += KG) {
    gather(k0);
    if (k0 == 0 && sel) {
      const float tw[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                           fi * (1.f - fj), fi * fj};
      float fa = 0.f, fb = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        fa = tap_add(fa, tw[t], za[t], t);
        fb = tap_add(fb, tw[t], zb[t], t);
      }
      // Both products rounded before the sum, as the plain version and K3
      // round them (a product fused into the sum is an ulp off at times).
      my_z = __fadd_rn(__fmul_rn(fa, hat(x, s0)),
                       s1 > s0 ? __fmul_rn(fb, hat(x, s1)) : 0.f);
    }
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int k = k0 + u;
      const float score = __shfl_sync(kFull, my_z, k & 31);
      if (k < 32 && ((selmask >> k) & 1)) {
        // Online-softmax update of a selected rank (reference: rank_step).
        const float new_m = fmaxf(m, score);
        const float safe_m = new_m <= kNegInf ? 0.f : new_m;
        const float rescale = expf((m <= kNegInf ? kNegInf : m) - safe_m);
        const float wv = expf(score - safe_m);
        l = l * rescale + wv;
#pragma unroll
        for (int q = 0; q < CPL; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s1a[q][e] = s1a[q][e] * rescale + wv * f[u][q][e];
            s2a[q][e] = s2a[q][e] * rescale + wv * f[u][q][e] * f[u][q][e];
          }
        m = new_m;
      }
    }
  }

  write_stats<T, CPL, kFlagship>(s1a, s2a, nullptr, nullptr, m, l,
                                 selmask != 0, lane, D, my_row, valid);
}

// B8's layouts: one point's stats row over its selected ranks alone, into
// my_row (shared memory), and its valid flag. Lane k < K has loaded rank
// k's inputs (in); the point's n selected ranks are compacted in rank
// order, lane j < n taking the j-th. Each rank goes through the arithmetic
// of lift_point above, expression for expression and in rank order, so
// that the sums, the variance's tie at 0 and the extremes' ties fall where
// they fall there and in K3 (the score's two products both rounded, as in
// lift_point and K3). On an H100 a spill cost more than a round
// trip (24 warps an SM hide one), so, within the bf16 bound of 80
// registers and without spills:
//   - the score (weighted) is formed before the taps are loaded, its loads
//     a round trip of their own (issued with the first taps, they spilled
//     and ran slower);
//   - a rank's lower-left tap is a pixel index (an int; the offset is
//     formed at the load), and its tap weights come from two shuffled
//     fractions once its taps have landed;
//   - each rank's combined features are pooled as soon as they are formed,
//     and only the selected ranks of a group are combined at all;
//   - in bf16 half a group's taps are in flight at a time (with a whole
//     group's, every B8 layout spilled).
template <typename T, int CPL, int kMode>
__device__ inline void lift_point_compact(const T* __restrict__ stack,
                                          const RankIn& in, long long point,
                                          int lane, const Dims& d, T* my_row,
                                          uint8_t* valid) {
  constexpr int KG = 4 / CPL;  // ranks per group
  // Ranks whose taps are in flight together: the whole group in f32, half
  // of it in bf16.
  constexpr int KF = sizeof(T) == 2 ? KG / 2 : KG;
  constexpr bool kW = (kMode & kWeighted) != 0;
  constexpr bool kMM = (kMode & kMinMax) != 0;
  using Raw = typename Quad<T>::Raw;
  const int C = d.C, D = d.D, S = C - D, W = d.W;
  const int b = (int)point / d.N;  // B N < 2^31
  const T* base = stack + (long long)b * d.R * W * C;
  const int down = W * C;

  const unsigned selmask = __ballot_sync(kFull, in.sel);
  const int n = __popc(selmask);
  const int src = lane < n ? nth_set_bit(selmask, lane) : lane;
  const int view = __shfl_sync(kFull, in.view, src);
  const float in_pi = __shfl_sync(kFull, in.pi, src);
  const float in_pj = __shfl_sync(kFull, in.pj, src);
  // Lane j < n: the j-th selected rank's tap fractions, lower-left tap
  // (pixel) and score.
  const bool sel = lane < n;
  float fi = 0.f, fj = 0.f, my_z = kNegInf;
  int pix = 0;
  if (sel) {
    const float pi = fminf(fmaxf(in_pi - 0.5f, 0.f), (float)(d.h - 1));
    const float pj = fminf(fmaxf(in_pj - 0.5f, 0.f), (float)(d.w - 1));
    const float li = floorf(pi), lj = floorf(pj);
    fi = pi - li;
    fj = pj - lj;
    pix = (view * (d.h + 1) + (int)li) * W + (int)lj;
    my_z = 0.f;  // unweighted: every selected rank scores 0
  }
  if constexpr (kW) {
    const float dep = __shfl_sync(kFull, in.dep, src);
    if (sel) {
      const float dc = fminf(fmaxf(dep, d.depth_min), d.depth_max);
      const float xr = logf(dc / d.depth_min) / d.log_range * (float)(S - 1);
      const float x = fminf(fmaxf(xr, 0.f), (float)(S - 1));
      const int s0 = min((int)x, S - 1), s1 = min(s0 + 1, S - 1);
      const T* t0 = base + (long long)pix * C + D;
      const T* taps[4] = {t0, t0 + C, t0 + down, t0 + down + C};
      float za[4], zb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        za[t] = to_float(taps[t][s0]);
        zb[t] = to_float(taps[t][s1]);
      }
      const float tw[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                           fi * (1.f - fj), fi * fj};
      float fa = 0.f, fb = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        fa = tap_add(fa, tw[t], za[t], t);
        fb = tap_add(fb, tw[t], zb[t], t);
      }
      // Both products rounded before the sum, as lift_point and K3 round
      // them (a product fused into the sum is an ulp off at times).
      my_z = __fadd_rn(__fmul_rn(fa, hat(x, s0)),
                       s1 > s0 ? __fmul_rn(fb, hat(x, s1)) : 0.f);
    }
  }

  float s1a[CPL][4], s2a[CPL][4], fmx[CPL][4], fmn[CPL][4];
#pragma unroll
  for (int q = 0; q < CPL; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1a[q][e] = 0.f;
      s2a[q][e] = 0.f;
      fmx[q][e] = -inf_f();
      fmn[q][e] = inf_f();
    }
  float m = kNegInf, l = 0.f;
  // The compacted ranks k0 .. k0 + KF - 1 (those below n): every tap
  // loaded before any is used, then each combined and pooled in order.
  const auto batch = [&](int k0) {
    Raw raw[KF][CPL][4];
#pragma unroll
    for (int u = 0; u < KF; ++u) {
      const int k = k0 + u;  // <= 31: k0 < n <= 32 and KF divides 32
      const int p = __shfl_sync(kFull, pix, k);
      if (k < n) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c0 = 4 * (lane + 32 * q);
          if (c0 < D) {
            const T* t = base + (long long)p * C + c0;
            raw[u][q][0] = Quad<T>::load(t);
            raw[u][q][1] = Quad<T>::load(t + C);
            raw[u][q][2] = Quad<T>::load(t + down);
            raw[u][q][3] = Quad<T>::load(t + down + C);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KF; ++u) {
      const int k = k0 + u;
      if (k >= n) break;  // warp-uniform
      const float gi = __shfl_sync(kFull, fi, k);
      const float gj = __shfl_sync(kFull, fj, k);
      const float score = __shfl_sync(kFull, my_z, k);
      const float tw[4] = {(1.f - gi) * (1.f - gj), (1.f - gi) * gj,
                           gi * (1.f - gj), gi * gj};
      float f[CPL][4];
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[q][e] = 0.f;
        if (4 * (lane + 32 * q) >= D) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v[4];
          Quad<T>::convert(raw[u][q][t], v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[q][e] = feature_tap_add(kMM, f[q][e], tw[t], v[e], t);
        }
      }
      // Online-softmax update of a selected rank (reference: rank_step).
      const float new_m = fmaxf(m, score);
      const float safe_m = new_m <= kNegInf ? 0.f : new_m;
      const float rescale = expf((m <= kNegInf ? kNegInf : m) - safe_m);
      const float wv = expf(score - safe_m);
      l = l * rescale + wv;
#pragma unroll
      for (int q = 0; q < CPL; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s1a[q][e] = s1a[q][e] * rescale + wv * f[q][e];
          s2a[q][e] = s2a[q][e] * rescale + wv * f[q][e] * f[q][e];
          if constexpr ((kMode & kMinMax) != 0) {
            fmx[q][e] = fmaxf(fmx[q][e], f[q][e]);
            fmn[q][e] = fminf(fmn[q][e], f[q][e]);
          }
        }
      m = new_m;
    }
  };
  if (n > KG) {
    for (int k0 = 0; k0 < n; k0 += KF) batch(k0);
  } else if (n > 0) {  // one group, its batches known at compile time
    batch(0);
    if constexpr (KF < KG) {
      if (n > KF) batch(KF);
    }
  }
  write_stats<T, CPL, kMode>(s1a, s2a, fmx, fmn, m, l, n > 0, lane, D,
                             my_row, valid);
}

// A warp walks kPointsPerWarp consecutive points. Their stats rows are one
// contiguous span: each row is staged in the warp's shared memory after
// the partial 16-byte chunk carried from the row before, whole chunks are
// written as 16-byte stores, and the span's first and last partial chunks
// (shared with the neighbouring warps' spans) as scalars.
template <typename T, int CPL, bool kOneGroup, int kMode>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks<T>)
lift_topk_fwd_kernel(
    const T* __restrict__ stack,           // [B, R, W, C]
    const int32_t* __restrict__ view_idx,  // [B, N, K]
    const float* __restrict__ p2d,         // [B, N, K, 2] (row, col) pixels
    const uint8_t* __restrict__ selected,  // [B, N, K]
    const float* __restrict__ depth,       // [B, N, K]
    T* __restrict__ stats,                 // [B, N, stats_width]
    uint8_t* __restrict__ valid,           // [B, N]
    Dims d) {
  constexpr int kPerVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = stats_width(kMode, d.D);
  T* buf = reinterpret_cast<T*>(smem) + warp * staged_stride<T>(row);
  const long long total = (long long)d.B * d.N;
  const long long p0 =
      ((long long)blockIdx.x * kWarps + warp) * kPointsPerWarp;
  if (p0 >= total) return;  // warp-uniform; the block never synchronizes
  const long long p1 = min(p0 + kPointsPerWarp, total);

  // buf[0, pending) holds the elements from global element `at` on (a
  // chunk boundary); on the first row its first `lead` are the previous
  // span's, not written here.
  long long at = p0 * row;
  int lead = (int)(at % kPerVec);
  at -= lead;
  int pending = lead;
  constexpr bool kW = (kMode & kWeighted) != 0;
  RankIn next =
      load_ranks<kW>(p0, lane, d, view_idx, p2d, selected, depth);
  for (long long point = p0; point < p1; ++point) {
    const RankIn in = next;
    if (point + 1 < p1)  // the next point's inputs load during this one
      next = load_ranks<kW>(point + 1, lane, d, view_idx, p2d, selected,
                            depth);
    if constexpr (kMode == kFlagship)
      lift_point<T, CPL, kOneGroup>(stack, in, point, lane, d, buf + pending,
                                    valid + point);
    else
      lift_point_compact<T, CPL, kMode>(stack, in, point, lane, d,
                                        buf + pending, valid + point);
    __syncwarp();
    const int count = pending + row;
    const int chunks = count / kPerVec;
    T* out = stats + at;
    int c = 0;
    if (lead) {
      for (int i = lead + lane; i < kPerVec; i += 32) out[i] = buf[i];
      c = 1;
      lead = 0;
    }
    const uint4* src = reinterpret_cast<const uint4*>(buf);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (c += lane; c < chunks; c += 32) dst[c] = src[c];
    const int rest = count - chunks * kPerVec;
    T carried;
    if (lane < rest) carried = buf[chunks * kPerVec + lane];
    __syncwarp();
    if (lane < rest) buf[lane] = carried;
    __syncwarp();
    at += (long long)chunks * kPerVec;
    pending = rest;
  }
  if (lane < pending) stats[at + lane] = buf[lane];
}

template <typename T, int CPL, int kMode>
int launch(const void* stack, const int32_t* view_idx, const float* p2d,
           const uint8_t* selected, const float* depth, void* stats,
           uint8_t* valid, const Dims& d, cudaStream_t stream) {
  const long long points = (long long)d.B * d.N;
  const long long per_block = (long long)kWarps * kPointsPerWarp;
  const unsigned blocks = (unsigned)((points + per_block - 1) / per_block);
  const int smem =
      kWarps * staged_stride<T>(stats_width(kMode, d.D)) * (int)sizeof(T);
  const auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    launches.add(kernel, "lift_topk_fwd_kernel", kWarps * 32, smem);
    kernel<<<blocks, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(stack), view_idx, p2d, selected, depth,
        static_cast<T*>(stats), valid, d);
    return (int)cudaGetLastError();
  };
  // The flagship's layout unrolls its one group of ranks where K fits it
  // (B8's layouts choose per point: lift_point_compact).
  if constexpr (kMode == kFlagship) {
    if (d.K <= 4 / CPL) return run(lift_topk_fwd_kernel<T, CPL, true, kMode>);
  }
  return run(lift_topk_fwd_kernel<T, CPL, false, kMode>);
}

template <typename T, int kMode>
int dispatch(const void* stack, const int32_t* view_idx, const float* p2d,
             const uint8_t* selected, const float* depth, void* stats,
             uint8_t* valid, const Dims& d, cudaStream_t stream) {
  const int cpl = (d.D + 127) / 128;
  if (cpl <= 1)
    return launch<T, 1, kMode>(stack, view_idx, p2d, selected, depth, stats,
                               valid, d, stream);
  if (cpl <= 2)
    return launch<T, 2, kMode>(stack, view_idx, p2d, selected, depth, stats,
                               valid, d, stream);
  if constexpr (kMode == kFlagship) {
    if (cpl <= 4)
      return launch<T, 4, kMode>(stack, view_idx, p2d, selected, depth,
                                 stats, valid, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The instantiation of the statistics layout `mode` (lift_stats.cuh).
template <typename T>
int dispatch_mode(int mode, const void* stack, const int32_t* view_idx,
                  const float* p2d, const uint8_t* selected,
                  const float* depth, void* stats, uint8_t* valid,
                  const Dims& d, cudaStream_t stream) {
#define SNAP_LIFT_MODE(M)                                                    \
  case M:                                                                    \
    return dispatch<T, M>(stack, view_idx, p2d, selected, depth, stats,      \
                          valid, d, stream);
  switch (mode) {
    SNAP_LIFT_MODE(0) SNAP_LIFT_MODE(1) SNAP_LIFT_MODE(2) SNAP_LIFT_MODE(3)
    SNAP_LIFT_MODE(4) SNAP_LIFT_MODE(5) SNAP_LIFT_MODE(6) SNAP_LIFT_MODE(7)
  }
#undef SNAP_LIFT_MODE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (bf16's launch bounds and
// register budget: the same width). weighted, use_variance and add_minmax
// pick the statistics layout, stats_row wide (lift_stats.cuh); weighted iff
// C > D. Needs D % 4 == 0, K <= 32, D <= 512 for the flagship's layout and
// D <= 256, fewer than 2^31 pixels an example (R W) and points (B N) for
// the others, and
// 16-byte aligned stack rows and stats.
// Returns a cudaError_t (0 on success).
extern "C" int lift_topk_fwd(
    const void* stack, const void* view_idx, const void* p2d,
    const void* selected, const void* depth, void* stats, void* valid,
    int dtype, int B, int N, int K, int R, int W, int C, int D, int h, int w,
    int weighted, int use_variance, int add_minmax, int stats_row,
    float depth_min, float depth_max, float log_range, void* stream) {
  launches.clear();
  const int mode = (weighted ? kWeighted : 0) |
                   (use_variance ? kVariance : 0) | (add_minmax ? kMinMax : 0);
  if (D % 4 || K > 32 || (weighted != 0) != (C > D) ||
      stats_row != stats_width(mode, D) ||
      (mode != kFlagship &&
       ((long long)R * W > INT_MAX || (long long)B * N > INT_MAX)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* idx = static_cast<const int32_t*>(view_idx);
  const auto* pts = static_cast<const float*>(p2d);
  const auto* sel = static_cast<const uint8_t*>(selected);
  const auto* dep = static_cast<const float*>(depth);
  auto* val = static_cast<uint8_t*>(valid);
  const Dims d{B, N, K, R, W, C, D, h, w, depth_min, depth_max, log_range};
  if (dtype == 0)
    return dispatch_mode<float>(mode, stack, idx, pts, sel, dep, stats, val, d,
                                s);
  if (dtype == 1)
    return dispatch_mode<__nv_bfloat16>(mode, stack, idx, pts, sel, dep, stats,
                                        val, d, s);
  if (dtype == 2)
    return dispatch_mode<__half>(mode, stack, idx, pts, sel, dep, stats, val,
                                 d, s);
  return (int)cudaErrorInvalidValue;
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int lift_topk_fwd_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
