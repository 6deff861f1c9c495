// The statistics layout of the top-k lift, K1 (lift_topk_fwd.cu) and K3
// (lift_topk_bwd.cu): per point the row
//   [mean (D), var (D)?, max (D)?, min (D)?, score_max (1)?]
// (snap_tpu/ops/view_fusion.py:pool_multiview_features). B8's three
// switches pick which are there; each is a bit of a kernel's compile-time
// mode, so that every layout is an instantiation of its own and the
// flagship's (weighted, variance) runs the code it ran before them.

#pragma once

#include <cuda_runtime.h>

// One tap's term of a rank's combined channel in the stated order: the
// taps t = 0..3 = (di, dj) = (0,0), (0,1), (1,0), (1,1) in that order, each
// product rounded on its own, added left to right from the first (t is a
// compile-time constant in every unrolled loop). No product is fused into
// the sum, so K1, K3 and view_scan._lift_ranks form the channel to the bit
// and route the max's, the min's and the score max's cotangents alike at
// near ties (ROADMAP C10).
__device__ __forceinline__ float tap_add(float acc, float w, float v,
                                         int t) {
  const float p = __fmul_rn(w, v);
  return t == 0 ? p : __fadd_rn(acc, p);
}

// One tap's term of a rank's feature channel. Only the layouts with the
// max and min (kMinMax) route a cotangent by the features' values, so only
// they take tap_add's stated order (``stated``); the others let the
// compiler fuse each product into the sum (an FMA, the accumulator from
// 0), as K1 and K3 formed every layout's features before that order: in
// the flagship's layout it cost K1 5.4% and K3 4.4% on an H100. The score
// bins take tap_add in every layout.
__device__ __forceinline__ float feature_tap_add(bool stated, float acc,
                                                 float w, float v, int t) {
  return stated ? tap_add(acc, w, v, t) : acc + w * v;
}

// +inf: the running min of the feature channels starts there, the max at
// its negative.
__device__ inline float inf_f() { return __int_as_float(0x7f800000); }

// Weighted fusion: the stack holds S = C - D score bins after the D
// features and the ranks are softmax-weighted by their depth scores;
// without it (C = D) every selected rank scores 0, the weights are equal,
// and no score max is written.
constexpr int kWeighted = 1;
// The variance channels.
constexpr int kVariance = 2;
// The max and min of each feature channel over the selected ranks.
constexpr int kMinMax = 4;
// The configs' default layout: [mean, var, score_max].
constexpr int kFlagship = kWeighted | kVariance;

__host__ __device__ constexpr int stats_width(int mode, int D) {
  return D * (1 + ((mode & kVariance) ? 1 : 0) + ((mode & kMinMax) ? 2 : 0)) +
         ((mode & kWeighted) ? 1 : 0);
}

// First channel of the max (the min follows it D channels on) and of the
// score max.
__host__ __device__ constexpr int max_offset(int mode, int D) {
  return D * (1 + ((mode & kVariance) ? 1 : 0));
}
