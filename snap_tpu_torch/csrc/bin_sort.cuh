// The scan of the counting sorts of the backward kernels (K3, K4): each
// kernel counts its items per bin and keeps each item's place within its
// bin; scan_kernel turns the counts into each bin's first slot; an item
// then goes to slot offsets[bin] + its place.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kScanMask = 0xffffffffu;  // every lane
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;  // counts a thread takes per step

// Each bin's first slot; offsets[nbins] = the number of items, also
// written to *total where given (a word the host reads). One block
// walks the counts kScanItems per thread at a time (16-byte loads and
// stores where a thread's items are whole), a warp-shuffle scan within each
// step and a running carry across steps.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    const int* __restrict__ counts, int* __restrict__ offsets, int nbins,
    int* total = nullptr) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;
  for (int first = 0; first < nbins; first += kScanItems * kScanThreads) {
    const int i0 = first + kScanItems * t;
    const bool whole = i0 + kScanItems <= nbins;
    int v[kScanItems], own = 0;
    if (whole) {
#pragma unroll
      for (int e = 0; e < kScanItems; e += 4) {
        const int4 q = *reinterpret_cast<const int4*>(counts + i0 + e);
        v[e] = q.x; v[e + 1] = q.y; v[e + 2] = q.z; v[e + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kScanItems; ++e)
        v[e] = i0 + e < nbins ? counts[i0 + e] : 0;
    }
#pragma unroll
    for (int e = 0; e < kScanItems; ++e) own += v[e];
    int incl = own;  // inclusive scan over the warp's threads
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kScanMask, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kScanMask, ws, off);
        if (lane >= off) ws += o;
      }
      warp_sums[lane] = ws;
    }
    __syncthreads();
    int next = carry + (warp ? warp_sums[warp - 1] : 0) + incl - own;
#pragma unroll
    for (int e = 0; e < kScanItems; ++e) {
      const int count = v[e];
      v[e] = next;
      next += count;
    }
    if (whole) {
#pragma unroll
      for (int e = 0; e < kScanItems; e += 4)
        *reinterpret_cast<int4*>(offsets + i0 + e) =
            make_int4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < kScanItems; ++e)
        if (i0 + e < nbins) offsets[i0 + e] = v[e];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is written again in the next step
  }
  if (t == 0) {
    offsets[nbins] = carry;
    if (total) *total = carry;
  }
}

}  // namespace
