// The statistics layout of the top-k lift, K1 (lift_topk_fwd.cu) and K3
// (lift_topk_bwd.cu): per point the row
//   [mean (D), var (D)?, max (D)?, min (D)?, score_max (1)?]
// (snap_tpu/ops/view_fusion.py:pool_multiview_features). B8's three
// switches pick which are there; each is a bit of a kernel's compile-time
// mode, so that every layout is an instantiation of its own and the
// flagship's (weighted, variance) runs the code it ran before them.

#pragma once

#include <cuda_runtime.h>

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
