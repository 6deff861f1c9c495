// The counting sorts of the backward kernels (K3, K4): each kernel counts
// its items per bin and keeps each item's place within its bin (from an
// atomic, so in an order that changes from run to run); scan_kernel turns
// the counts into each bin's first slot; an item then goes to slot
// offsets[bin] + its place. order_bins_kernel then turns each item's place
// into its rank by key (its index) among its bin's items, so that a bin's
// slots hold its items in ascending index and the order in which they are
// summed is the same on every run.

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

constexpr int kOrderThreads = 128;
constexpr int kOrderTile = 2048;  // keys staged in shared memory at a time

// Per bin b, its slots [offsets[b], min(offsets[b + 1], limit)) hold the
// distinct keys of its items (keys[slot]: an item's index), placed in any
// order: within[key] becomes the item's place in the bin in ascending key
// order, so that slot offsets[b] + within[key] orders the bin by key. A
// block takes a bin at a time (grid-stride). A bin of L <= kOrderThreads
// keys (most: ~114 a bin on K3's training input) is ranked by counting:
// each thread counts the keys below its own over the bin's keys staged in
// shared memory and read 4 at a time (L comparisons a thread). A larger one
// (the border's pile-ups reach ~1,500) is sorted in shared memory by a
// bitonic network padded to a power of two (~n log^2 n / 2 compare-swaps
// over the block, n the padded size, against L^2 comparisons), and each
// key's place read off; past kOrderTile keys, counting again, kOrderTile
// staged at a time.
__global__ void __launch_bounds__(kOrderThreads) order_bins_kernel(
    const int* __restrict__ keys, const int* __restrict__ offsets, int nbins,
    int limit, int* __restrict__ within) {
  __shared__ __align__(16) int tile[kOrderTile];
  const int t = threadIdx.x;
  for (int bin = blockIdx.x; bin < nbins; bin += gridDim.x) {
    const int s = offsets[bin];
    const int L = min(offsets[bin + 1], limit) - s;  // uniform over the block
    if (L <= 1) {
      if (L == 1 && t == 0) within[keys[s]] = 0;
      continue;
    }
    if (L > kOrderThreads && L <= kOrderTile) {
      int n = kOrderThreads;
      while (n < L) n <<= 1;
      __syncthreads();  // the tile's last readers are done
      for (int j = t; j < n; j += kOrderThreads)
        tile[j] = j < L ? keys[s + j] : 0x7fffffff;  // the padding sorts last
      __syncthreads();
      for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = t; i < n; i += kOrderThreads) {
            const int other = i ^ j;
            if (other > i) {
              const int a = tile[i], b = tile[other];
              if ((a > b) == ((i & k) == 0)) {
                tile[i] = b;
                tile[other] = a;
              }
            }
          }
          __syncthreads();
        }
      }
      for (int i = t; i < L; i += kOrderThreads) within[tile[i]] = i;
      continue;
    }
    for (int i0 = 0; i0 < L; i0 += kOrderThreads) {
      const int i = i0 + t;
      const int mine = i < L ? keys[s + i] : 0;
      int below = 0;
      for (int t0 = 0; t0 < L; t0 += kOrderTile) {
        const int n = min(kOrderTile, L - t0);
        if (L > kOrderTile || i0 == 0) {
          __syncthreads();  // the tile's last readers are done
          for (int j = t; j < n; j += kOrderThreads) tile[j] = keys[s + t0 + j];
          __syncthreads();
        }
        if (i < L) {
          const int4* quads = reinterpret_cast<const int4*>(tile);
          int j = 0;
#pragma unroll 4
          for (; j + 4 <= n; j += 4) {
            const int4 q = quads[j >> 2];
            below += (q.x < mine) + (q.y < mine) + (q.z < mine) +
                     (q.w < mine);
          }
          for (; j < n; ++j) below += tile[j] < mine;
        }
      }
      if (i < L) within[mine] = below;
    }
  }
}

}  // namespace
