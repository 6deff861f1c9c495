// K4: backward of the bilinear 2x2 patch sampler (K2), in f32, bf16 or f16
// (the sums in f32, rounded once to g's dtype, f16 past 65504 to inf; a
// non-finite g reaches the plane's gradient).
//
// Replaces X2: the custom VJP of snap_tpu/ops/view_scan.py:
// gather_bilinear_patches (_make_patch_gather bwd, :334-347: the flat-row
// scatter-add of the 2x2 patch cotangent, the transpose of the 2x2xC gather
// of tools/pallas_gather_probe.py:patch_gather_pallas) together with the
// transpose of interpolate_patch_2d's bilinear combine (:487-547). The
// exhaustive pose backend's templates send their gradient through it to the
// query BEV.
//
// Input: g = d values [B, P, D] in the plane's dtype and the points
// [B, P, 2] f32, as K2 took them. Per point, with K2's clamped taps and
// weights (the same f32 coordinates, the low-edge collapse included),
// w_tap * g goes to each of its 4 taps, for every point, valid or not: the
// caller's where() has already zeroed g where the sample is invalid. The
// sums are formed in f32 and written once in the plane's dtype into
// [B, H+1, W+1, C]; the validity channel (C = D + 1) gets 0. The caller's
// edge padding folds the pad row and column back onto the edge.
//
// Design: the points are sorted by the cell of their lower tap, so that
// the sum over a cell's points is formed in registers, not with one scalar
// atomic per point, tap and channel (157M at batch 2 on the training path
// onto 627k addresses, ~250 each: the first design's limit, L2's atomic
// units, at 0.44 ms). A point's bin is (example, lower-tap cell): B x H x W
// bins, 19,200 at batch 2. A memset of the counts and six launches from one
// call:
//   1. bin: a block takes a contiguous range of points and counts them per
//      bin in shared memory (the bins of its examples, in windows of 12,288
//      at most: one on the training path), each point keeping its place
//      among the block's points of its bin; then one atomic per bin adds
//      the block's count to the global one, lanes on consecutive bins, and
//      its old value is the block's first place in the bin. Counting in
//      shared memory takes the border's pile-ups (~21% of the template
//      points lie off the plane and clamp onto border cells, up to ~1,000
//      in a bin) and turns 1.2M scattered atomics (~25 us on the training
//      path's input) into one per block and bin, on consecutive addresses.
//      Both atomics make a point's slot change from run to run.
//   2. scan: one block turns the counts into each bin's first slot.
//   3. order: each point writes its index (its key) into its slot, then a
//      block per bin (bin_sort.cuh) replaces each point's place by its rank
//      in ascending index among the bin's points: from here on a bin's
//      slots hold its points in ascending index.
//   4. place: each point's record (its tap fractions, index and bin, 16
//      bytes) goes to its slot, its bin's first slot plus its place.
//   5. runs: a walker of L lanes takes a chunk of consecutive slots, as
//      many walkers as the card keeps resident (one wave, at most
//      heads_capacity); each lane holds 16 bytes of g (8 bf16 or 4 f32
//      channels; a scalar load per channel where rows are not 16-byte
//      aligned, as at D = 17) and sums w_tap * g of the consecutive points
//      of one bin in registers (4 taps x its channels), in slot order, the
//      next group's records fetched while a group's channels are in flight.
//      When the bin changes, or the chunk ends, the 4 tap sums go to the
//      bin's piece: its own [4, Dp] f32 row of `partial` where the bin
//      starts in this walker's chunk, else the walker's row of `heads` (a
//      bin longer than a chunk, the border's pile-ups, is split across
//      walkers, a piece each). Where D exceeds 32 lanes' worth, grid.y
//      takes slabs.
//   6. fold: every entry of d plane, in the plane's dtype, is +0.0 plus, in
//      this order, the pieces of the bins whose taps reach its cell (i, j):
//      tap (lower, lower) of bin (i, j), (lower, upper) of (i, j - 1),
//      (upper, lower) of (i - 1, j), (upper, upper) of (i - 1, j - 1), each
//      bin's pieces in chunk order; one f32 sum, rounded once; the validity
//      channel 0.
// The order of every sum is therefore fixed by the inputs alone: each piece
// is the left fold from +0.0, in ascending point index, of its points'
// w_tap * g, and each entry the fold of its pieces just stated; no float
// atomics, so two calls on the same inputs give the same bits. The plain
// version (ops/view_scan.py:patch_sample_2d_bwd_plain) sums with
// index_add_ in another order and is not held to these bits.
//
// What bounds it on an H100: bytes. g (2D bytes a point), the points (8 B)
// read once and d plane written once: 89.8 MB at batch 2 on the training
// path (g 78.6 MB in bf16), 0.027 ms at 3.35 TB/s. The design's own
// traffic: the points read four times (39 MB, mostly L2 hits after the
// first), each point's place (4 B), key (4 B) and record (16 B) written
// and read once (59 MB, mostly L2-resident: the L2 holds 50 MB), the pieces
// written and read once (19,200 bins x 4 taps x 32 channels x 4 B = 9.8 MB
// each way), and the order stage's comparisons (bin_sort.cuh).
// What holds it above the bound is not bytes but scattered accesses: the
// place stage's 1.2M record stores to sorted slots and the run stage's g
// rows, 64 bytes each (bf16, D = 32) read from scattered places in sorted
// order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "bin_sort.cuh"
#include "launch_log.cuh"

namespace {

LaunchLog launches;

constexpr int kBinThreads = 1024;
constexpr int kWindow = 12288;  // bins counted in a block's 48 KB at a time
constexpr int kFlush = 4;       // bins a thread adds to the counts together
constexpr int kPointThreads = 256;  // place and cast stages
constexpr int kRunThreads = 128;
constexpr int kGroup = 4;  // slots a walker of the run stage fetches together

// Shapes shared by the stages; Dp = D rounded up to 4 (the pieces' rows).
struct Dims {
  int B, P, H, W, C, D, Dp;
};

// K2's coordinates of point p: clamp, floor, and the low-edge collapse (a
// point in [0, 0.5) clamps to 0 and gives the upper tap weight 0). Its bin
// is (example, lower-tap cell).
struct Tap {
  int bin;
  float fi, fj;
};

__device__ inline Tap tap_of(const float2* points, int p, const Dims& d) {
  const float2 xy = points[p];
  const float pi = fminf(fmaxf(xy.x - 0.5f, 0.f), (float)(d.H - 1));
  const float pj = fminf(fmaxf(xy.y - 0.5f, 0.f), (float)(d.W - 1));
  const int li = min((int)floorf(pi), d.H - 1);
  const int lj = min((int)floorf(pj), d.W - 1);
  return {((p / d.P) * d.H + li) * d.W + lj, pi - (float)li, pj - (float)lj};
}

// 1. Per bin, the number of points; per point, its place in its bin. A
// block takes a contiguous range of the points and counts them per bin in
// shared memory, for a window of at most kWindow bins at a time (the bins
// of the examples its points lie in; one window on the training path).
// Then each bin's count goes to the global one with one atomic, lanes on
// consecutive bins, whose old value is the block's first place in that
// bin; the points' places within the block are added to it.
__global__ void __launch_bounds__(kBinThreads, 2) bin_points_kernel(
    const float2* __restrict__ points, int* __restrict__ counts,
    int* __restrict__ within, Dims d) {
  __shared__ int hist[kWindow];
  const int n = d.B * d.P, cells = d.H * d.W;
  const int per_block = (n + gridDim.x - 1) / gridDim.x;
  const int p0 = blockIdx.x * per_block, p1 = min(n, p0 + per_block);
  if (p0 >= p1) return;  // the whole block
  const int lo = p0 / d.P * cells, hi = ((p1 - 1) / d.P + 1) * cells;
  for (int w0 = lo; w0 < hi; w0 += kWindow) {
    const int size = min(kWindow, hi - w0);
    for (int i = threadIdx.x; i < size; i += kBinThreads) hist[i] = 0;
    __syncthreads();
    for (int p = p0 + threadIdx.x; p < p1; p += kBinThreads) {
      const int bin = tap_of(points, p, d).bin - w0;
      if (bin >= 0 && bin < size) within[p] = atomicAdd(hist + bin, 1);
    }
    __syncthreads();
    // kFlush bins a thread at a time, their atomics in flight together.
    for (int i0 = threadIdx.x; i0 < size; i0 += kFlush * kBinThreads) {
      int c[kFlush];
#pragma unroll
      for (int k = 0; k < kFlush; ++k) {
        const int i = i0 + k * kBinThreads;
        c[k] = i < size ? hist[i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kFlush; ++k)
        if (c[k]) c[k] = atomicAdd(counts + w0 + i0 + k * kBinThreads, c[k]);
#pragma unroll
      for (int k = 0; k < kFlush; ++k) {
        const int i = i0 + k * kBinThreads;
        if (i < size) hist[i] = c[k];
      }
    }
    __syncthreads();
    for (int p = p0 + threadIdx.x; p < p1; p += kBinThreads) {
      const int bin = tap_of(points, p, d).bin - w0;
      if (bin >= 0 && bin < size) within[p] += hist[bin];
    }
    __syncthreads();  // hist is zeroed again for the next window
  }
}

// 3. Each point's index into its slot (its bin's first slot plus the place
// the bin stage gave it), for the order stage.
__global__ void __launch_bounds__(kPointThreads) keys_kernel(
    const float2* __restrict__ points, const int* __restrict__ offsets,
    const int* __restrict__ within, int* __restrict__ keys, Dims d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d.B * d.P) return;
  keys[offsets[tap_of(points, p, d).bin] + within[p]] = p;
}

// 4. Each point's record {fi, fj, point, bin} into its slot, its bin's
// first slot plus its place.
__global__ void __launch_bounds__(kPointThreads) place_points_kernel(
    const float2* __restrict__ points, const int* __restrict__ offsets,
    const int* __restrict__ within, int4* __restrict__ records, Dims d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d.B * d.P) return;
  const Tap t = tap_of(points, p, d);
  records[offsets[t.bin] + within[p]] =
      make_int4(__float_as_int(t.fi), __float_as_int(t.fj), p, t.bin);
}

// 16 bytes of g's channels: V = 4 (f32) or 8 (bf16, f16), loaded raw.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int V = 4;
  __device__ static void convert(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
  __device__ static float scalar(const float* p) { return *p; }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void convert(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <> struct Chunk<__half> {
  static constexpr int V = 8;
  __device__ static void convert(const uint4& v, float* out) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static float scalar(const __half* p) { return __half2float(*p); }
};

// 5. Walker (thread / lanes) takes slots [walker * chunk, + chunk) of the
// sorted order (chunk a multiple of kGroup); lane `sub` of it holds
// channels c0 .. c0 + V - 1 of the block's slab.
// kVec: g's rows are 16-byte aligned (D * sizeof(T) % 16 == 0), one 16-byte
// load per point; else a scalar load per channel.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRunThreads) sum_runs_kernel(
    const T* __restrict__ g_values, const int4* __restrict__ records,
    const int* __restrict__ offsets, float* __restrict__ partial,
    float* __restrict__ heads, int lanes, int chunk, Dims d) {
  constexpr int V = Chunk<T>::V;
  const int n = d.B * d.P;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int sub = t % lanes, walker = t / lanes;
  const long long begin = (long long)walker * chunk;
  const int c0 = (blockIdx.y * lanes + sub) * V;
  if (begin >= n || c0 >= d.D) return;
  const int end = (int)min((long long)n, begin + chunk);

  float sum[4][V];  // taps x channels
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < V; ++e) sum[q][e] = 0.f;
  int cur = -1;
  auto flush = [&]() {
    float* piece = offsets[cur] >= begin
                       ? partial + (long long)cur * 4 * d.Dp
                       : heads + (long long)walker * 4 * d.Dp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (c0 + e < d.D) piece[q * d.Dp + c0 + e] = sum[q][e];
        sum[q][e] = 0.f;
      }
    }
  };
  // A group's records (the lanes of a walker load the same ones: one
  // request); {0, 0, 0, -1} past the end.
  auto fetch = [&](int j0, int4 (&rec)[kGroup]) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      rec[u] = j0 + u < end ? records[j0 + u] : make_int4(0, 0, 0, -1);
  };

  int4 rec[kGroup];
  fetch((int)begin, rec);
  for (int j0 = (int)begin; j0 < end; j0 += kGroup) {
    // The group's channels in flight, then the next group's records, before
    // the first add.
    uint4 raw[kGroup];
    if (kVec) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        raw[u] = rec[u].w >= 0
                     ? __ldcs(reinterpret_cast<const uint4*>(
                           g_values + (long long)rec[u].z * d.D + c0))
                     : make_uint4(0, 0, 0, 0);
    }
    int4 next[kGroup];
    fetch(j0 + kGroup, next);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (rec[u].w < 0) break;  // past the end
      if (rec[u].w != cur) {
        if (cur >= 0) flush();
        cur = rec[u].w;
      }
      float v[V];
      if (kVec) {
        Chunk<T>::convert(raw[u], v);
      } else {
        const T* row = g_values + (long long)rec[u].z * d.D + c0;
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[e] = c0 + e < d.D ? Chunk<T>::scalar(row + e) : 0.f;
      }
      const float fi = __int_as_float(rec[u].x), fj = __int_as_float(rec[u].y);
      const float tw[4] = {(1.f - fi) * (1.f - fj), (1.f - fi) * fj,
                           fi * (1.f - fj), fi * fj};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) sum[q][e] += tw[q] * v[e];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) rec[u] = next[u];
  }
  if (cur >= 0) flush();
}

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// Round to nearest; a sum past 65504 becomes inf, as a cast of the f32 sum
// to float16 does.
__device__ inline void store(__half* p, float x) { *p = __float2half_rn(x); }

// 6. d plane [B, H+1, W+1, C] in the plane's dtype, a thread an entry: from
// +0.0, the pieces of the bins whose taps reach its cell (i, j), in tap
// order (lower, lower) of bin (i, j), (lower, upper) of (i, j - 1), (upper,
// lower) of (i - 1, j), (upper, upper) of (i - 1, j - 1), each bin's pieces
// in chunk order; channels from D on (the validity channel) get 0.
template <typename T>
__global__ void __launch_bounds__(kPointThreads) fold_kernel(
    const float* __restrict__ partial, const float* __restrict__ heads,
    const int* __restrict__ offsets, T* __restrict__ out, long long total,
    int chunk, Dims d) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long cell = t / d.C;
  const int c = (int)(t - cell * d.C);
  float sum = 0.f;
  if (c < d.D) {
    const int j = (int)(cell % (d.W + 1));
    const long long rest = cell / (d.W + 1);
    const int i = (int)(rest % (d.H + 1));
    const int b = (int)(rest / (d.H + 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bi = i - (q >> 1), bj = j - (q & 1);
      if (bi < 0 || bi >= d.H || bj < 0 || bj >= d.W) continue;
      const long long bin = ((long long)b * d.H + bi) * d.W + bj;
      const int first = offsets[bin], last = offsets[bin + 1];
      if (last <= first) continue;
      sum += partial[(bin * 4 + q) * d.Dp + c];
      for (int k = first / chunk + 1; k <= (last - 1) / chunk; ++k)
        sum += heads[((long long)k * 4 + q) * d.Dp + c];
    }
  }
  store(out + t, sum);
}

// The run stage's plan: walkers of `lanes` lanes (a power of two covering D
// in chunks of V channels, at most a warp; wider D goes in slabs along
// grid.y), as many as the card keeps resident at once and at most
// heads_capacity, each taking an equal chunk of the ordered places (a
// multiple of kGroup): one wave.
struct RunPlan {
  int lanes, slabs, chunk;
  long long walkers;
};

template <typename T, bool kVec>
int plan_runs(const Dims& d, int sms, int heads_capacity, RunPlan* plan) {
  constexpr int V = Chunk<T>::V;
  const int need = (d.D + V - 1) / V;
  int lanes = 1;
  while (lanes < need && lanes < 32) lanes *= 2;
  const int slabs = (d.D + lanes * V - 1) / (lanes * V);
  const long long n = (long long)d.B * d.P;
  int per_sm = 0;
  const int code = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sum_runs_kernel<T, kVec>, kRunThreads, 0);
  if (code) return code;
  long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms *
                       kRunThreads / lanes / slabs;
  if (resident > heads_capacity) resident = heads_capacity;
  if (resident < 1) resident = 1;
  long long chunk = (n + resident - 1) / resident;
  chunk = (chunk + kGroup - 1) / kGroup * kGroup;
  *plan = {lanes, slabs, (int)chunk, (n + chunk - 1) / chunk};
  return 0;
}

template <typename T, bool kVec>
int launch_runs(const T* g, const int4* records, const int* offsets,
                float* partial, float* heads, const RunPlan& plan,
                const Dims& d, cudaStream_t stream) {
  const dim3 grid(
      (unsigned)((plan.walkers * plan.lanes + kRunThreads - 1) / kRunThreads),
      (unsigned)plan.slabs);
  launches.add(sum_runs_kernel<T, kVec>, "sum_runs_kernel", kRunThreads, 0);
  sum_runs_kernel<T, kVec><<<grid, kRunThreads, 0, stream>>>(
      g, records, offsets, partial, heads, plan.lanes, plan.chunk, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fold(const float* partial, const float* heads, const int* offsets,
                void* out, int chunk, const Dims& d, cudaStream_t stream) {
  const long long total = (long long)d.B * (d.H + 1) * (d.W + 1) * d.C;
  launches.add(fold_kernel<T>, "fold_kernel", kPointThreads, 0);
  fold_kernel<T><<<(unsigned)((total + kPointThreads - 1) / kPointThreads),
                   kPointThreads, 0, stream>>>(
      partial, heads, offsets, static_cast<T*>(out), total, chunk, d);
  return (int)cudaGetLastError();
}

// Stages 5 and 6 in g's dtype T.
template <typename T>
int runs_and_fold(const void* g_values, const int4* records,
                  const int* offsets, float* partial, float* heads,
                  void* grad, int heads_capacity, const Dims& d, int sms,
                  cudaStream_t s) {
  const auto* g = static_cast<const T*>(g_values);
  const bool vec = (d.D * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  RunPlan plan;
  int code = vec ? plan_runs<T, true>(d, sms, heads_capacity, &plan)
                 : plan_runs<T, false>(d, sms, heads_capacity, &plan);
  if (code) return code;
  code = vec ? launch_runs<T, true>(g, records, offsets, partial, heads,
                                    plan, d, s)
             : launch_runs<T, false>(g, records, offsets, partial, heads,
                                     plan, d, s);
  if (code) return code;
  return launch_fold<T>(partial, heads, offsets, grad, plan.chunk, d, s);
}

// Stages 1-4: the points' records in their slots, each bin's in ascending
// point index; counts zeroed.
int sort_points(const float2* points, int* counts, int* offsets, int* within,
                int* keys, int4* records, const Dims& d, int sms,
                cudaStream_t s) {
  const long long n = (long long)d.B * d.P;
  const int nbins = d.B * d.H * d.W;
  int code = 0;
  // The bin stage: two blocks a SM (one wave), each on a contiguous range
  // of points.
  launches.add(bin_points_kernel, "bin_points_kernel", kBinThreads, 0);
  bin_points_kernel<<<2 * sms, kBinThreads, 0, s>>>(points, counts, within,
                                                    d);
  if ((code = (int)cudaGetLastError())) return code;
  launches.add(scan_kernel, "scan_kernel", kScanThreads, 0);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offsets, nbins);
  if ((code = (int)cudaGetLastError())) return code;
  const unsigned blocks = (unsigned)((n + kPointThreads - 1) / kPointThreads);
  launches.add(keys_kernel, "keys_kernel", kPointThreads, 0);
  keys_kernel<<<blocks, kPointThreads, 0, s>>>(points, offsets, within, keys,
                                               d);
  if ((code = (int)cudaGetLastError())) return code;
  // Each bin's places in ascending point index.
  launches.add(order_bins_kernel, "order_bins_kernel", kOrderThreads, 0);
  order_bins_kernel<<<16 * sms, kOrderThreads, 0, s>>>(keys, offsets, nbins,
                                                       (int)n, within);
  if ((code = (int)cudaGetLastError())) return code;
  launches.add(place_points_kernel, "place_points_kernel", kPointThreads, 0);
  place_points_kernel<<<blocks, kPointThreads, 0, s>>>(points, offsets,
                                                       within, records, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (g_values and grad). Scratch,
// allocated by the caller, with Dp = D rounded up to 4: counts [B * H * W]
// and offsets [B * H * W + 1] int32 (16-byte aligned), within and keys
// [B * P] int32, records [B * P] int4, partial [B * H * W, 4, Dp] f32 and
// heads [heads_capacity, 4, Dp] f32, heads_capacity >= 1 (the run stage takes
// at most that many walkers); counts are zeroed here. points 8-byte aligned;
// B * P and B * H * W in [1, 2^30). grad [B, H+1, W+1, C], every entry
// written. Returns a cudaError_t (0 on success).
extern "C" int patch_sample_2d_bwd(const void* g_values, const void* points,
                                   void* grad, void* counts, void* offsets,
                                   void* within, void* keys, void* records,
                                   void* partial, void* heads,
                                   int heads_capacity, int dtype, int B,
                                   int P, int H, int W, int C, int D,
                                   void* stream) {
  launches.clear();
  if (dtype < 0 || dtype > 2 || D <= 0 || D > C || H <= 0 || W <= 0 ||
      B <= 0 || P <= 0 || heads_capacity < 1 ||
      reinterpret_cast<uintptr_t>(points) % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d{B, P, H, W, C, D, (D + 3) & ~3};
  int device = 0, sms = 0;
  int code = (int)cudaGetDevice(&device);
  if (!code)
    code = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device);
  if (!code)
    code = (int)cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * H * W,
                                s);
  auto* rec = static_cast<int4*>(records);
  auto* off = static_cast<int*>(offsets);
  auto* part = static_cast<float*>(partial);
  auto* head = static_cast<float*>(heads);
  if (!code)
    code = sort_points(static_cast<const float2*>(points),
                       static_cast<int*>(counts), off,
                       static_cast<int*>(within), static_cast<int*>(keys),
                       rec, d, sms, s);
  if (code) return code;
  if (dtype == 0)
    return runs_and_fold<float>(g_values, rec, off, part, head, grad,
                                heads_capacity, d, sms, s);
  if (dtype == 1)
    return runs_and_fold<__nv_bfloat16>(g_values, rec, off, part, head,
                                        grad, heads_capacity, d, sms, s);
  return runs_and_fold<__half>(g_values, rec, off, part, head, grad,
                               heads_capacity, d, sms, s);
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int patch_sample_2d_bwd_occupancy(KernelOccupancy* out,
                                             int capacity) {
  return launches.report(out, capacity);
}
