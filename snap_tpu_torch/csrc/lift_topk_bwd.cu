// K3: fused top-k lift, backward (training path). The stack and g_stats in
// f32, bf16 or f16; every sum in f32, d stack f32 (the wrapper casts it to
// the stack's dtype, f16 past 65504 to inf); a non-finite g reaches d stack.
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
// and w_tap * [d f_k, d c_k] goes to each of the 4 taps of each selected
// rank, summed in f32 into a [B, R, W, C] buffer that the wrapper casts to
// the stack's dtype. Coordinates, selection and depth get no gradient.
//
// B8, the other statistics layouts (lift_stats.cuh), each a compile-time
// mode of its own: unweighted (C = D: z_k = 0 for every selected rank, so
// p is uniform, and nothing reaches a score bin), without the variance
// (gE2 = 0), and with the max and min of each channel, whose cotangents
// add to d f_k down the chains f_max = where(select, max(f_max, f_k),
// f_max) (and the min's) as jnp.maximum's gradient runs them: all of it to
// the rank that last set the max strictly, and at each later exact tie
// half of what reaches it to each side. In rank order that is: the rank
// that last set it takes 2^-T of g_max, T the ties met after it, and the
// i-th of those ties 2^-(T - i + 1). Every layout runs the code below
// (any K <= 32, D <= 256).
//
// Design: the selected ranks are sorted by the pixel of their lower tap, so
// that the sum over a pixel's ranks is formed in registers, not with one
// scalar atomic per rank, tap and channel (~280 per address on the training
// path). The scratch and the last stages' grids are sized by the count of
// selected ranks (the caller's, `capacity`), not by every rank: the scan
// form's 20 ranks a point select ~3.7. Launches from one call:
//   1. count: one thread per rank; a selected rank's bin is (example, view,
//      lower-tap pixel). Lanes of a warp with the same bin add their number
//      to the bin's count with one atomic (__match_any_sync), and each rank
//      keeps its place within the bin, in an order that changes from run to
//      run.
//   2. scan: one block turns the counts (108k bins on the training path)
//      into each bin's first slot and the total.
//   3. order: each selected rank writes its index (its key) into its slot,
//      then a block per bin (bin_sort.cuh) replaces each rank's place by its
//      rank in ascending index among the bin's (bins hold ~114 ranks on the
//      training path, the largest ~1,500): from here on a bin's slots hold
//      its ranks in ascending (point, rank) index.
//   4. ranks: one warp per point. The point's selected ranks are compacted
//      in rank order (a ballot; lane j takes the j-th), and the warp
//      recomputes the forward exactly as K1 does, in that order (the
//      variance's tie rule makes the rounding of E2 - mean^2 matter),
//      writes d f_k (D f32) into the rank's slot of the sorted order, then
//      d z_k, and each rank's lane writes its record (the tap fractions,
//      the depth-hat abscissa, d z_k) and its bin. Writing d f_k (512 B per
//      rank at D = 128) moves fewer bytes than the point's f32 gmu and gE2
//      rows (1 KB, read again for every rank of the point). Each lane holds
//      4 feature channels per 128 (D % 4 == 0, D <= 256), and lane j forms
//      z_j from the two depth bins whose hat is non-zero. A point with at
//      most 4 selected ranks (every point of the stream, nearly every one
//      of the scan) takes one group whose loop is known at compile time:
//      its combined features stay in registers for pass 2, where the max's
//      and min's shares are formed from those very registers, so that no
//      chain state lives across the passes and no tie can round
//      differently (a loop bound known only at run time cost ~1 ms on the
//      training path's input, and the chain state took the stage to 162
//      registers and 3 blocks of 128 an SM). A point with more (a tie at
//      the scan's threshold selects more than top_k) goes on a list (its
//      place there from an atomic: the list's order does not matter, as
//      each listed point writes its own slots alone) that
//   4b. wide ranks takes after: a warp a listed point, groups of 4 ranks
//      gathered again in pass 2, and per channel the rank that last set the
//      max (min) strictly and a bit for each tie after it noted in pass 1,
//      from which pass 2 forms the shares. One instantiation for every
//      layout (its mode read at run time); not launched where K <= 4.
//   5. runs: one block per kChunk consecutive slots. Its feature warps give
//      each lane 4 channels of d f, its score warps a depth bin each; a warp
//      adds w_tap * [d f_k, d c_k] of consecutive ranks of one pixel into
//      registers (4 taps x 4 channels), in slot order, and when the pixel
//      changes writes the 4 tap sums to the pixel's piece: the bin's own
//      [4, C] f32 row of `partial` where the bin starts in this block, else
//      the block's row of `heads` (a bin longer than the rest of a block
//      goes on in the next ones, a piece each).
//   6. fold: every entry of d stack, in the stack's dtype, is +0.0 plus, in
//      this order, the pieces of the bins whose taps reach it: tap (lower,
//      lower) of the pixel at its own place (i, j), (lower, upper) of (i, j
//      - 1), (upper, lower) of (i - 1, j), (upper, upper) of (i - 1, j - 1),
//      each bin's pieces in block order; one f32 sum, rounded once.
// The order of every sum is therefore fixed by the inputs alone: each piece
// is the left fold from +0.0, in ascending (point, rank) index, of its
// ranks' w_tap * [d f_k, d c_k] (each product and each d f_k formed as
// above), and each entry the fold of its pieces just stated; no float
// atomics, so two calls on the same inputs give the same bits. The plain
// version (ops/view_scan.py:lift_topk_bwd_plain) sums with index_add_ in
// another order and is not held to these bits.
// No stage writes past the scratch: a slot at or past capacity is skipped.
// The scan writes the count stage's total into a word of pinned host
// memory, which the wrapper compares with capacity once the call has ended
// (without a wait for the card), and raises on a difference.
// This departs from the 8 x 8 tile bins with a shared-memory accumulator
// that were tried first: there each rank's read-modify-writes of shared
// memory (4 taps x C floats, ~5 KB) bound the last stage at ~1.4 ms on the
// training path's input, and it took 3.2 ms on an H100; the pixel runs
// need no shared memory.
//
// What bounds it on an H100: operations. The bound counts ~3.8k f32
// operations per selected rank (7.84M at batch 2 on the training path) and
// the inputs, g (2.3M x 257 x 2 B = 1.18 GB) and the output read or written
// once: 0.49 ms. The design adds its own traffic: the stack's gathers
// (L2-resident: the stack is 36 MB at batch 2), the d f rows written and
// read once (4.4 GB each way at batch 2, ~2.6 ms at 3.35 TB/s: the runs
// stage reads them in ~1.6 ms unweighted), and the fixed order's: the
// pieces, written once and read once by the fold (75k non-empty bins x 4
// taps x 160 channels x 4 B = 0.19 GB each way on the training path, ~0.11
// ms), and the order stage's keys (4 B a rank each way) and comparisons
// (bin_sort.cuh). The
// design before the pixel runs (one warp per point, ~4 G scalar f32 atomics
// into a 71.8 MB buffer, more than the 50 MB L2) ran at 40x the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "bin_sort.cuh"
#include "launch_log.cuh"
#include "lift_stats.cuh"

namespace {

LaunchLog launches;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountThreads = 256;
constexpr int kRankThreads = 128;  // 4 points per block of the rank stage
constexpr int kChunk = 512;        // sorted ranks per block of the run stage
constexpr int kGroup = 8;          // ranks a run-stage warp fetches together
constexpr int kMaxRunWarps = 8;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline float to_float(__half x) { return __half2float(x); }

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

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ inline float hat(float x, int s) {
  return fmaxf(0.f, 1.f - fabsf(x - (float)s));
}

// A pixel coordinate clamped to the taps' range [0, n - 1].
__device__ inline float clamped(float p, int n) {
  return fminf(fmaxf(p - 0.5f, 0.f), (float)(n - 1));
}

// A rank's lower tap, tap fractions and depth-hat abscissa, as K1 forms
// them.
struct Geo {
  int li, lj;
  float fi, fj, x;
};

__device__ inline Geo rank_geo(float p_i, float p_j, float dep, int h, int w,
                               int S, float depth_min, float depth_max,
                               float log_range) {
  Geo g;
  const float pi = clamped(p_i, h), pj = clamped(p_j, w);
  const float li = floorf(pi), lj = floorf(pj);
  g.li = (int)li;
  g.lj = (int)lj;
  g.fi = pi - li;
  g.fj = pj - lj;
  g.x = 0.f;  // no score bins: unweighted
  if (S > 0) {
    const float d = fminf(fmaxf(dep, depth_min), depth_max);
    const float x = logf(d / depth_min) / log_range * (float)(S - 1);
    g.x = fminf(fmaxf(x, 0.f), (float)(S - 1));
  }
  return g;
}

__device__ inline void tap_weights(float fi, float fj, float* w) {
  w[0] = (1.f - fi) * (1.f - fj);
  w[1] = (1.f - fi) * fj;
  w[2] = fi * (1.f - fj);
  w[3] = fi * fj;
}

// Shapes shared by the stages.
struct Dims {
  int B, N, K, R, W, C, D, h, w;
  int V;  // views: R = V (h + 1)
  float depth_min, depth_max, log_range;
  int mode;  // the statistics layout (lift_stats.cuh)
};

// A rank's bin: its example, view and lower-tap pixel.
__device__ inline int bin_of(const Dims& d, int b, int view, int li, int lj) {
  return ((b * d.V + view) * d.h + li) * d.w + lj;
}

// 1. Per bin, the number of selected ranks; per rank, its place in its bin.
__global__ void __launch_bounds__(kCountThreads) count_kernel(
    const int32_t* __restrict__ view_idx, const float* __restrict__ p2d,
    const uint8_t* __restrict__ selected, int* __restrict__ counts,
    int* __restrict__ within, Dims d) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)d.B * d.N * d.K;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // The loop runs warp by warp (its bound is uniform over a warp), so that
  // every lane takes part in the ballot.
  for (long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x -
                         lane;
       first < total; first += stride) {
    const long long r = first + lane;
    const bool sel = r < total && selected[r];
    int bin = -1;
    if (sel) {
      bin = bin_of(d, (int)(r / ((long long)d.N * d.K)), view_idx[r],
                   (int)floorf(clamped(p2d[2 * r], d.h)),
                   (int)floorf(clamped(p2d[2 * r + 1], d.w)));
    }
    const unsigned active = __ballot_sync(kFull, sel);
    if (sel) {
      const unsigned peers = __match_any_sync(active, bin);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counts + bin, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      within[r] = base + __popc(peers & ((1u << lane) - 1u));
    }
  }
}

// 3. Each selected rank's index into its slot (its bin's first slot plus
// the place the count stage gave it), for the order stage.
__global__ void __launch_bounds__(kCountThreads) keys_kernel(
    const int32_t* __restrict__ view_idx, const float* __restrict__ p2d,
    const uint8_t* __restrict__ selected, const int* __restrict__ offsets,
    const int* __restrict__ within, int* __restrict__ keys, int capacity,
    Dims d) {
  const long long total = (long long)d.B * d.N * d.K;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < total; r += (long long)gridDim.x * blockDim.x) {
    if (!selected[r]) continue;
    const int bin = bin_of(d, (int)(r / ((long long)d.N * d.K)), view_idx[r],
                           (int)floorf(clamped(p2d[2 * r], d.h)),
                           (int)floorf(clamped(p2d[2 * r + 1], d.w)));
    const int slot = offsets[bin] + within[r];
    if (slot < capacity) keys[slot] = (int)r;
  }
}

// The position of the (j + 1)-th set bit of mask, j < __popc(mask).
__device__ inline int nth_set_bit(unsigned mask, int j) {
  for (int i = 0; i < j; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// Lane j < n of a point's warp: the point's j-th selected rank in rank
// order (its geometry, first tap, bin and slot in the sorted order), of the
// n whose bits are set in sel. Lane k < K has loaded rank k's inputs
// (in_*: view, pixel coordinates, depth, place in its bin; read for an
// unselected rank too and ignored); lane j takes its rank's by shuffles.
struct LaneRank {
  bool sel;  // j < n
  Geo geo;
  long long tap0;  // element offset of the lower-left tap in the example
  int bin, slot;
};

__device__ inline LaneRank compact_rank(const Dims& d, int b, int lane,
                                        unsigned sel, int n, int in_view,
                                        float in_pi, float in_pj,
                                        float in_dep, int in_pos,
                                        const int* offsets) {
  const int src = lane < n ? nth_set_bit(sel, lane) : lane;
  const int view = __shfl_sync(kFull, in_view, src);
  const float pi = __shfl_sync(kFull, in_pi, src);
  const float pj = __shfl_sync(kFull, in_pj, src);
  const float dep = __shfl_sync(kFull, in_dep, src);
  const int pos = __shfl_sync(kFull, in_pos, src);
  LaneRank m{false, {0, 0, 0.f, 0.f, 0.f}, 0, 0, 0};
  if (lane < n) {
    m.sel = true;
    m.geo = rank_geo(pi, pj, dep, d.h, d.w, d.C - d.D, d.depth_min,
                     d.depth_max, d.log_range);
    m.tap0 = (((long long)view * (d.h + 1) + m.geo.li) * d.W + m.geo.lj) *
             d.C;
    m.bin = bin_of(d, b, view, m.geo.li, m.geo.lj);
    m.slot = offsets[m.bin] + pos;
  }
  return m;
}

// The online-softmax update of a selected rank (K1's rank_step).
template <int CPL, int E>
__device__ inline void online_update(float score, const float (&f)[CPL][E],
                                     float& m, float& l, float (&s1)[CPL][E],
                                     float (&s2)[CPL][E]) {
  const float new_m = fmaxf(m, score);
  const float safe_m = new_m <= kNegInf ? 0.f : new_m;
  const float rescale = expf((m <= kNegInf ? kNegInf : m) - safe_m);
  const float wv = expf(score - safe_m);
  l = l * rescale + wv;
#pragma unroll
  for (int q = 0; q < CPL; ++q)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s1[q][e] = s1[q][e] * rescale + wv * f[q][e];
      s2[q][e] = s2[q][e] * rescale + wv * f[q][e] * f[q][e];
    }
  m = new_m;
}

// gmu and gE2 of a lane's channels (channel c = (cell + 32 q) E + e) from
// the pooled sums and the cotangent.
template <int CPL, int E>
__device__ inline void point_grads(const float (&s1)[CPL][E],
                                   const float (&s2)[CPL][E], float l_safe,
                                   const float (&g_mean)[CPL][E],
                                   const float (&g_var)[CPL][E], int cell,
                                   int D, float (&gmu)[CPL][E],
                                   float (&ge2)[CPL][E]) {
#pragma unroll
  for (int q = 0; q < CPL; ++q)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      gmu[q][e] = 0.f;
      ge2[q][e] = 0.f;
      if ((cell + 32 * q) * E + e < D) {
        const float mean = __fdiv_rn(s1[q][e], l_safe);
        const float e2 = __fdiv_rn(s2[q][e], l_safe);
        const float var_raw = __fsub_rn(e2, __fmul_rn(mean, mean));
        const float tau = var_raw > 0.f ? 1.f : (var_raw == 0.f ? 0.5f : 0.f);
        ge2[q][e] = g_var[q][e] * tau;
        gmu[q][e] = g_mean[q][e] - 2.f * mean * ge2[q][e];
      }
    }
}

// The share of g_m that m = max(..max(max(-1e30, z_0), z_1).., z_{K-1})
// passes to z_lane. Exclusive prefix max of z over the lanes (ranks) gives
// the running max before each rank; an exclusive suffix product of the
// factors (0 past a strict new max, 1/2 past a tie, 1 otherwise) gives what
// reaches it.
__device__ inline float max_chain_share(int lane, int K, float my_z,
                                        float g_m) {
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
  return g_m * after * (gt ? 1.f : (eq ? 0.5f : 0.f));
}

// d f of one rank for a lane's channels, into the rank's d f row (none
// where row is null), and the lane's part of u. With extra_on, the max's and
// min's shares of the rank (extra) add to d f.
template <int CPL, int E>
__device__ inline float emit_d_f(const float (&f)[CPL][E], float p,
                                 const float (&gmu)[CPL][E],
                                 const float (&ge2)[CPL][E],
                                 const float (&extra)[CPL][E], bool extra_on,
                                 int cell, int D, float* row) {
  float partial = 0.f;
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int c0 = (cell + 32 * q) * E;
    float df[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      df[e] = 0.f;
      if (c0 + e < D) {
        partial += gmu[q][e] * f[q][e] + ge2[q][e] * f[q][e] * f[q][e];
        df[e] = p * (gmu[q][e] + 2.f * ge2[q][e] * f[q][e]);
        if (extra_on) df[e] += extra[q][e];
      }
    }
    // Whole float4s: D % 4 == 0, so the rows are 16-byte aligned.
#pragma unroll
    for (int e = 0; e < E; e += 4)
      if (row != nullptr && c0 + e < D)
        __stcs(reinterpret_cast<float4*>(row + c0 + e),
               make_float4(df[e], df[e + 1], df[e + 2], df[e + 3]));
  }
  return partial;
}

// The share of an extreme's cotangent g that rank k takes, given the rank
// that last set the extreme strictly (at) and a bit for each rank that tied
// it after that (ties): 2^-T for the rank that set it, T the ties; for a
// tie 2^-(the ties at or after it).
__device__ inline float extreme_share(int k, int at, unsigned ties, float g) {
  if (k == at) return ldexpf(g, -__popc(ties));
  if ((ties >> k) & 1u) return ldexpf(g, -__popc(ties >> k));
  return 0.f;
}

// The same shares from the values themselves, for the first n of KG ranks
// held in registers: walking back from the last, all of what reaches a
// rank that set the running max strictly, and half at an exact tie (half
// passes on); added into share.
template <int KG>
__device__ inline void add_extreme_shares(const float (&v)[KG], int n,
                                          float g, float (&share)[KG]) {
  float before[KG];
  float m = -inf_f();
#pragma unroll
  for (int u = 0; u < KG; ++u) {
    before[u] = m;
    if (u < n) m = fmaxf(m, v[u]);
  }
  float coef = g;
#pragma unroll
  for (int u = KG - 1; u >= 0; --u) {
    if (u >= n) continue;
    if (v[u] > before[u]) {
      share[u] += coef;
      coef = 0.f;
    } else if (v[u] == before[u]) {
      share[u] += 0.5f * coef;
      coef *= 0.5f;
    }
  }
}

// The last step of a point: d z_k and the records of its n selected ranks
// (none past the scratch's capacity).
__device__ inline void write_records(const LaneRank& me, int lane, int n,
                                     float my_z, float my_p, float my_u,
                                     float g_m, float4* records, int* bins,
                                     int capacity) {
  const float sum_pu = warp_sum(my_p * my_u);
  const float share = max_chain_share(lane, n, my_z, g_m);
  if (me.sel && me.slot < capacity) {
    const float dz = my_p * (my_u - sum_pu) + share;
    records[me.slot] = make_float4(me.geo.fi, me.geo.fj, me.geo.x, dz);
    bins[me.slot] = me.bin;
  }
}

// 4. Per point: the forward again, d f_k into the sorted slots, records.
// Lane l holds feature channels 4 (l + 32 q) .. + 3, q < CPL (D <= 128 CPL).
// The point's n selected ranks are compacted in rank order (lane j takes
// the j-th), the order of the online softmax and of every chain of maxima:
// an unselected rank adds nothing to those sums and takes no share of a
// chain's cotangent (it scores -1e30, and the first selected rank passes 0
// back past it). Lane j forms z_j from the two depth bins whose hat is
// non-zero. The ranks go in groups of 4, every tap of a group loaded before
// any is used.
//   narrow (!kWide, every point with n <= 4): one group, its loop known at
//     compile time, so the combined features stay in registers for pass 2;
//     the max's and min's shares are formed there from those same
//     registers, so no tie can round differently between the passes. A
//     point with more ranks goes on the wide list.
//   wide (the list): the group loop bound is n, pass 2 gathers each group
//     again, and pass 1 notes per channel the rank that last set the max
//     (min) strictly and a bit for each tie after it, from which pass 2
//     forms the shares without comparing values gathered twice.
// kMode is the statistics layout (lift_stats.cuh), or -1 for the wide
// stage, which reads it from d.mode (one instantiation for every layout).
// Nothing is written at a slot past capacity.
template <typename T, int CPL, bool kWide, int kMode>
__device__ __forceinline__ void rank_point(
    const T* __restrict__ stack, const int32_t* __restrict__ view_idx,
    const float* __restrict__ p2d, const uint8_t* __restrict__ selected,
    const float* __restrict__ depth, const T* __restrict__ g_stats,
    const int* __restrict__ offsets, const int* __restrict__ within,
    float* __restrict__ d_f, float4* __restrict__ records,
    int* __restrict__ bins, int* __restrict__ wide_points,
    int* __restrict__ wide_count, int capacity, const Dims& d,
    long long point, int lane) {
  constexpr int KG = 4;  // ranks per group
  const int mode = kMode >= 0 ? kMode : d.mode;
  const bool weighted = (mode & kWeighted) != 0;
  const bool variance = (mode & kVariance) != 0;
  const bool minmax = (mode & kMinMax) != 0;
  using Raw = typename Quad<T>::Raw;
  const int b = (int)(point / d.N);
  const int C = d.C, D = d.D, S = C - D, W = d.W;
  const long long r0 = point * d.K;
  bool in_sel = false;
  int in_view = 0, in_pos = 0;
  float in_pi = 0.f, in_pj = 0.f, in_dep = 0.f;
  if (lane < d.K) {
    const long long r = r0 + lane;
    in_sel = selected[r];
    in_view = view_idx[r];
    in_pi = p2d[2 * r];
    in_pj = p2d[2 * r + 1];
    in_dep = depth[r];
    in_pos = within[r];
  }
  const unsigned sel = __ballot_sync(kFull, in_sel);
  if (!sel) return;  // invalid point: g is zero, nothing to add
  const int n = __popc(sel);
  if (!kWide && n > KG) {
    if (lane == 0) wide_points[atomicAdd(wide_count, 1)] = (int)point;
    return;
  }
  const LaneRank me = compact_rank(d, b, lane, sel, n, in_view, in_pi, in_pj,
                                   in_dep, in_pos, offsets);

  const T* base = stack + (long long)b * d.R * W * C;
  const long long down = (long long)W * C;
  // The point's cotangent for the lane's channels, fetched ahead (read
  // once: evict first, so that the stack stays in L2); the max's and min's
  // when pass 2 needs them.
  const int row = stats_width(mode, D), at_max = max_offset(mode, D);
  const T* g = g_stats + point * row;
  float g_mean[CPL][4], g_var[CPL][4], g_max[CPL][4], g_min[CPL][4];
  auto load_g = [&](float (&out)[CPL][4], int at) {
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c0 = 4 * (lane + 32 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[q][e] = c0 < D ? to_float(__ldcs(g + at + c0 + e)) : 0.f;
    }
  };
  load_g(g_mean, 0);
#pragma unroll
  for (int q = 0; q < CPL; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) g_var[q][e] = 0.f;
  if (variance) load_g(g_var, D);
  if (kWide && minmax) {
    load_g(g_max, at_max);
    load_g(g_min, at_max + D);
  }
  const float g_m = weighted ? to_float(g[row - 1]) : 0.f;

  // Lane j: rank j's score from the two depth bins around x.
  float my_z = kNegInf;
  if (!weighted && me.sel) my_z = 0.f;
  if (weighted && me.sel) {
    float tw[4];
    tap_weights(me.geo.fi, me.geo.fj, tw);
    const int s0 = min((int)me.geo.x, S - 1), s1 = min(s0 + 1, S - 1);
    const T* taps[4] = {base + me.tap0, base + me.tap0 + C,
                        base + me.tap0 + down, base + me.tap0 + down + C};
    float fa = 0.f, fb = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      fa = tap_add(fa, tw[t], to_float(taps[t][D + s0]), t);
      fb = tap_add(fb, tw[t], to_float(taps[t][D + s1]), t);
    }
    // Both products rounded before the sum, as K1 and the plain version
    // round them (a product fused into the sum is an ulp off at times, and
    // moves the score max's cotangent at a near tie).
    my_z = __fadd_rn(__fmul_rn(fa, hat(me.geo.x, s0)),
                     s1 > s0 ? __fmul_rn(fb, hat(me.geo.x, s1)) : 0.f);
  }

  // The combined features of ranks k0 .. k0 + 3 for the lane's channels.
  float f[KG][CPL][4];
  auto gather = [&](int k0) {
    Raw raw[KG][CPL][4];
    float tw[KG][4];
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int k = k0 + u;
      const long long off = __shfl_sync(kFull, me.tap0, k);
      tap_weights(__shfl_sync(kFull, me.geo.fi, k),
                  __shfl_sync(kFull, me.geo.fj, k), tw[u]);
      const bool on = k < n;
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
            f[u][q][e] = feature_tap_add(minmax, f[u][q][e], tw[u][t], v[e],
                                         t);
        }
      }
  };

  // Pass 1: the online softmax in rank order, as K1 and the reference run
  // it; wide, with the max and min, per channel the extreme, the rank that
  // last set it strictly and a bit for each rank that tied it since.
  float s1[CPL][4], s2[CPL][4], mx[CPL][4], mn[CPL][4];
  int mx_at[CPL][4], mn_at[CPL][4];
  unsigned mx_ties[CPL][4], mn_ties[CPL][4];
#pragma unroll
  for (int q = 0; q < CPL; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1[q][e] = 0.f;
      s2[q][e] = 0.f;
      if (kWide && minmax) {
        mx[q][e] = -inf_f();
        mn[q][e] = inf_f();
        mx_at[q][e] = mn_at[q][e] = 0;
        mx_ties[q][e] = mn_ties[q][e] = 0u;
      }
    }
  float m = kNegInf, l = 0.f;
  const int num_k = kWide ? n : KG;  // k0 + u <= 31 as n <= K <= 32
  for (int k0 = 0; k0 < num_k; k0 += KG) {
    gather(k0);
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int k = k0 + u;
      const float score = __shfl_sync(kFull, my_z, k);
      if (k < n) {
        online_update(score, f[u], m, l, s1, s2);
        if (kWide && minmax) {
#pragma unroll
          for (int q = 0; q < CPL; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = f[u][q][e];
              if (v > mx[q][e]) {
                mx[q][e] = v;
                mx_at[q][e] = k;
                mx_ties[q][e] = 0u;
              } else if (v == mx[q][e]) {
                mx_ties[q][e] |= 1u << k;
              }
              if (v < mn[q][e]) {
                mn[q][e] = v;
                mn_at[q][e] = k;
                mn_ties[q][e] = 0u;
              } else if (v == mn[q][e]) {
                mn_ties[q][e] |= 1u << k;
              }
            }
        }
      }
    }
  }

  const float l_safe = fmaxf(l, 1e-20f);
  float gmu[CPL][4], ge2[CPL][4];
  point_grads(s1, s2, l_safe, g_mean, g_var, lane, D, gmu, ge2);
  const float my_p = me.sel ? expf(my_z - m) / l_safe : 0.f;

  // Narrow, with the max and min: each rank's shares of g_max and g_min
  // from the registers pass 1 read.
  float extra[KG][CPL][4];
  if (!kWide && minmax) {
    load_g(g_max, at_max);
    load_g(g_min, at_max + D);
#pragma unroll
    for (int q = 0; q < CPL; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v[KG], to_max[KG], to_min[KG];
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          v[u] = f[u][q][e];
          to_max[u] = to_min[u] = 0.f;
        }
        add_extreme_shares(v, n, g_max[q][e], to_max);
#pragma unroll
        for (int u = 0; u < KG; ++u) v[u] = -v[u];
        add_extreme_shares(v, n, g_min[q][e], to_min);
#pragma unroll
        for (int u = 0; u < KG; ++u) extra[u][q][e] = to_max[u] + to_min[u];
      }
  }

  // Pass 2: d f_k into rank k's slot; lane k keeps u_k.
  float my_u = 0.f;
  for (int k0 = 0; k0 < num_k; k0 += KG) {
    if (kWide) gather(k0);
    float u[KG];
#pragma unroll
    for (int v = 0; v < KG; ++v) {
      const int k = k0 + v;
      const float p = __shfl_sync(kFull, my_p, k);
      const int slot = __shfl_sync(kFull, me.slot, k);
      u[v] = 0.f;
      if (k < n) {
        float shares[CPL][4];
#pragma unroll
        for (int q = 0; q < CPL; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            shares[q][e] = !minmax ? 0.f
                           : kWide ? extreme_share(k, mx_at[q][e],
                                                   mx_ties[q][e],
                                                   g_max[q][e]) +
                                         extreme_share(k, mn_at[q][e],
                                                       mn_ties[q][e],
                                                       g_min[q][e])
                                   : extra[v][q][e];
        u[v] = emit_d_f<CPL, 4>(
            f[v], p, gmu, ge2, shares, minmax, lane, D,
            slot < capacity ? d_f + (long long)slot * D : nullptr);
      }
    }
    if (weighted) {
#pragma unroll
      for (int v = 0; v < KG; ++v) {
        const float sum = warp_sum(u[v]);
        if (lane == k0 + v) my_u = sum;
      }
    }
  }
  if (weighted) {
    write_records(me, lane, n, my_z, my_p, my_u, g_m, records, bins,
                  capacity);
  } else if (me.sel && me.slot < capacity) {
    // Unweighted: no score bins, so the runs read the tap fractions alone.
    records[me.slot] = make_float4(me.geo.fi, me.geo.fj, 0.f, 0.f);
    bins[me.slot] = me.bin;
  }
}

#define SNAP_RANK_PARAMS                                                    \
  const T *__restrict__ stack, const int32_t *__restrict__ view_idx,        \
      const float *__restrict__ p2d, const uint8_t *__restrict__ selected,  \
      const float *__restrict__ depth, const T *__restrict__ g_stats,       \
      const int *__restrict__ offsets, const int *__restrict__ within,      \
      float *__restrict__ d_f, float4 *__restrict__ records,                \
      int *__restrict__ bins, int *__restrict__ wide_points,                \
      int *__restrict__ wide_count, int capacity, Dims d
#define SNAP_RANK_ARGS                                                      \
  stack, view_idx, p2d, selected, depth, g_stats, offsets, within, d_f,     \
      records, bins, wide_points, wide_count, capacity, d

// 4, narrow: one warp per point of the [B, N] grid (kRankThreads / 32 a
// block).
template <typename T, int CPL, int kMode>
__global__ void __launch_bounds__(kRankThreads)
    ranks_kernel(SNAP_RANK_PARAMS) {
  const long long point =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (point >= (long long)d.B * d.N) return;
  rank_point<T, CPL, false, kMode>(SNAP_RANK_ARGS, point, threadIdx.x & 31);
}

// 4b, wide: the listed points, a warp each, over the grid in turn.
template <typename T, int CPL>
__global__ void __launch_bounds__(kRankThreads)
    wide_ranks_kernel(SNAP_RANK_PARAMS) {
  const int warps = blockDim.x >> 5, count = *wide_count;
  for (int i = blockIdx.x * warps + (threadIdx.x >> 5); i < count;
       i += gridDim.x * warps)
    rank_point<T, CPL, true, -1>(SNAP_RANK_ARGS, wide_points[i],
                                 threadIdx.x & 31);
}

// 5. Per block of kChunk consecutive slots (of the first capacity, each
// bin's in ascending rank index): the first feature_warps warps hold 4
// channels of d f per lane, the others a depth bin per lane; each warp sums
// a pixel's consecutive ranks in registers, in slot order,
// and when the pixel changes writes the sum of each of its 4 taps (every
// channel, zeros too) to the pixel's piece: partial[bin] where the bin
// starts in this block, else heads[block] (the bin began in an earlier
// block; a block has at most one such bin, its first).
__global__ void __launch_bounds__(kMaxRunWarps * 32) runs_kernel(
    const float* __restrict__ d_f, const float4* __restrict__ records,
    const int* __restrict__ bins, const int* __restrict__ offsets,
    float* __restrict__ partial,
    float* __restrict__ heads, int nbins, int capacity, int feature_warps,
    Dims d) {
  const int begin = blockIdx.x * kChunk;
  const int end = min(min(offsets[nbins], capacity), begin + kChunk);
  if (begin >= end) return;
  const int C = d.C, D = d.D, S = C - D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool feature = warp < feature_warps;
  const int c0 = 4 * (warp * 32 + lane);             // feature warps
  const int s = (warp - feature_warps) * 32 + lane;  // score warps
  const bool active = feature ? c0 < D : s < S;

  float acc[4][4];  // taps x (4 channels, or the depth bin in [q][0])
  int cur = -1;
  auto flush = [&]() {
    float* piece = offsets[cur] >= begin
                       ? partial + (long long)cur * 4 * C
                       : heads + (long long)blockIdx.x * 4 * C;
    if (active) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (feature)
          *reinterpret_cast<float4*>(piece + q * C + c0) =
              make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        else
          piece[q * C + D + s] = acc[q][0];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  };
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  for (int j0 = begin; j0 < end; j0 += kGroup) {
    // Lane u holds the record and bin of slot j0 + u; a feature lane has
    // its channels of the group's d f rows in flight before the first add.
    const int n = min(kGroup, end - j0);
    float4 rec = make_float4(0.f, 0.f, 0.f, 0.f);
    int bin = -1;
    if (lane < n) {
      rec = records[j0 + lane];
      bin = bins[j0 + lane];
    }
    float4 v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (feature && active && u < n)
        v[u] = __ldcs(reinterpret_cast<const float4*>(
            d_f + (long long)(j0 + u) * D + c0));
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (u >= n) break;  // warp-uniform
      const int pixel = __shfl_sync(kFull, bin, u);
      if (pixel != cur) {  // warp-uniform
        if (cur >= 0) flush();
        cur = pixel;
      }
      float tw[4];
      tap_weights(__shfl_sync(kFull, rec.x, u), __shfl_sync(kFull, rec.y, u),
                  tw);
      const float x = __shfl_sync(kFull, rec.z, u);
      const float dz = __shfl_sync(kFull, rec.w, u);
      if (feature) {
        const float val[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] += tw[q] * val[e];
      } else if (active) {
        const float dc = dz * hat(x, s);
        if (dc != 0.f) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q][0] += tw[q] * dc;
        }
      }
    }
  }
  if (cur >= 0) flush();
}

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// Round to nearest; a sum past 65504 becomes inf, as torch's cast of an f32
// sum to float16 does.
__device__ inline void store(__half* p, float x) { *p = __float2half_rn(x); }

// 6. d stack [B, R, W, C] in the stack's dtype, every entry written: a
// thread per 4 channels of a tap (example-view ev, row i in [0, h], column
// j). From +0.0 it adds, in this order, the pieces of the bins whose taps
// reach it: tap (lower, lower) of bin (i, j), (lower, upper) of (i, j - 1),
// (upper, lower) of (i - 1, j), (upper, upper) of (i - 1, j - 1); each bin's
// pieces in block order (partial[bin], then heads of the later blocks its
// places reach). One f32 sum, rounded once.
template <typename T>
__global__ void __launch_bounds__(256) fold_kernel(
    const float* __restrict__ partial, const float* __restrict__ heads,
    const int* __restrict__ offsets, T* __restrict__ out, int capacity,
    Dims d) {
  const long long quads = (long long)d.B * d.R * d.W * (d.C / 4);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= quads) return;
  const int C = d.C;
  const int c = (int)(t % (C / 4)) * 4;
  const long long tap = t / (C / 4);
  const int j = (int)(tap % d.W);
  const long long row = tap / d.W;  // (example * V + view) * (h + 1) + i
  const int i = (int)(row % (d.h + 1));
  const long long ev = row / (d.h + 1);
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  auto add = [&](const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    sum[0] += v.x; sum[1] += v.y; sum[2] += v.z; sum[3] += v.w;
  };
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int bi = i - (q >> 1), bj = j - (q & 1);
    if (bi < 0 || bi >= d.h || bj < 0 || bj >= d.w) continue;
    const long long bin = (ev * d.h + bi) * d.w + bj;
    const int first = offsets[bin];
    const int last = min(offsets[bin + 1], capacity);
    if (last <= first) continue;
    add(partial + (bin * 4 + q) * C + c);
    for (int k = first / kChunk + 1; k <= (last - 1) / kChunk; ++k)
      add(heads + ((long long)k * 4 + q) * C + c);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) store(out + tap * C + c + e, sum[e]);
}

// The wide stage's blocks: enough to keep every SM busy over any list.
constexpr int kWideBlocksPerSm = 8;

template <typename T, int kMode>
int launch_ranks(const void* stack, const int32_t* view_idx, const float* p2d,
                 const uint8_t* selected, const float* depth,
                 const void* g_stats, const int* offsets, const int* within,
                 float* d_f, float4* records, int* bins, int* wide_points,
                 int* wide_count, int capacity, const Dims& d, int sms,
                 cudaStream_t stream) {
  constexpr int kPerBlock = kRankThreads / 32;
  const long long points = (long long)d.B * d.N;
  const unsigned blocks = (unsigned)((points + kPerBlock - 1) / kPerBlock);
  const auto* st = static_cast<const T*>(stack);
  const auto* g = static_cast<const T*>(g_stats);
  const auto run = [&](auto kernel, const char* name, unsigned grid) {
    launches.add(kernel, name, kRankThreads, 0);
    kernel<<<grid, kRankThreads, 0, stream>>>(
        st, view_idx, p2d, selected, depth, g, offsets, within, d_f, records,
        bins, wide_points, wide_count, capacity, d);
    return (int)cudaGetLastError();
  };
  int code = d.D <= 128 ? run(ranks_kernel<T, 1, kMode>, "ranks_kernel",
                              blocks)
                        : run(ranks_kernel<T, 2, kMode>, "ranks_kernel",
                              blocks);
  if (code || d.K <= 4) return code;  // with K <= 4 the wide list is empty
  const long long most = (long long)kWideBlocksPerSm * sms;
  const unsigned wide = (unsigned)(blocks < most ? blocks : most);
  return d.D <= 128 ? run(wide_ranks_kernel<T, 1>, "wide_ranks_kernel", wide)
                    : run(wide_ranks_kernel<T, 2>, "wide_ranks_kernel", wide);
}

// The instantiation of the statistics layout `mode` (lift_stats.cuh).
template <typename T>
int launch_ranks_mode(int mode, const void* stack, const int32_t* view_idx,
                      const float* p2d, const uint8_t* selected,
                      const float* depth, const void* g_stats,
                      const int* offsets, const int* within, float* d_f,
                      float4* records, int* bins, int* wide_points,
                      int* wide_count, int capacity, const Dims& d, int sms,
                      cudaStream_t stream) {
#define SNAP_LIFT_MODE(M)                                                    \
  case M:                                                                    \
    return launch_ranks<T, M>(stack, view_idx, p2d, selected, depth, g_stats, \
                              offsets, within, d_f, records, bins,           \
                              wide_points, wide_count, capacity, d, sms,     \
                              stream);
  switch (mode) {
    SNAP_LIFT_MODE(0) SNAP_LIFT_MODE(1) SNAP_LIFT_MODE(2) SNAP_LIFT_MODE(3)
    SNAP_LIFT_MODE(4) SNAP_LIFT_MODE(5) SNAP_LIFT_MODE(6) SNAP_LIFT_MODE(7)
  }
#undef SNAP_LIFT_MODE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fold(const float* partial, const float* heads, const int* offsets,
                void* grad, int capacity, const Dims& d, cudaStream_t s) {
  const long long quads = (long long)d.B * d.R * d.W * (d.C / 4);
  launches.add(fold_kernel<T>, "fold_kernel", 256, 0);
  fold_kernel<T><<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      partial, heads, offsets, static_cast<T*>(grad), capacity, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (stack, g_stats and grad).
// weighted, use_variance and add_minmax pick the statistics layout,
// stats_row wide (lift_stats.cuh); weighted iff C > D. Scratch, allocated by
// the caller: counts [bins + 1] int32 zeroed (the last, the wide list's
// length), offsets [bins + 1] int32, within [B * N * K] int32, wide_points
// [B * N] int32, partial [bins, 4, C] f32 and, for capacity slots, the count
// of selected ranks: d_f [capacity, D] f32, records [capacity, 4] f32,
// bins_of_slots and keys [capacity] int32, and heads [ceil(capacity / 512),
// 4, C] f32; bins = B * V * h * w and V = R / (h + 1). No stage writes a
// slot past capacity, whatever the count stage finds; the count it found goes
// to found, one int32 of pinned host memory, for the caller to compare with
// capacity once the launches have ended. grad [B, R, W, C] in the stack's
// dtype, every entry written; C * dtype size a multiple of 16 bytes; D % 4 ==
// 0 and D <= 256; C <= 256; K <= 32; B * N * K < 2^31. Returns a cudaError_t
// (0 on success).
extern "C" int lift_topk_bwd(
    const void* stack, const void* view_idx, const void* p2d,
    const void* selected, const void* depth, const void* g_stats, void* grad,
    void* counts, void* offsets, void* within, void* d_f, void* records,
    void* bins_of_slots, void* keys, void* partial, void* heads,
    void* wide_points, void* found, int dtype, int B, int N, int K, int R,
    int W, int C, int D, int h, int w, int weighted, int use_variance,
    int add_minmax, int stats_row, int capacity, float depth_min,
    float depth_max, float log_range, void* stream) {
  launches.clear();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int feature_warps = (D + 127) / 128, score_warps = (C - D + 31) / 32;
  const int mode = (weighted ? kWeighted : 0) |
                   (use_variance ? kVariance : 0) | (add_minmax ? kMinMax : 0);
  if (K > 32 || (C & 3) || (D & 3) || dtype < 0 || dtype > 2 ||
      feature_warps + score_warps > kMaxRunWarps || capacity < 0 ||
      (weighted != 0) != (C > D) || stats_row != stats_width(mode, D) ||
      (long long)B * N * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Dims d{B, N, K, R, W, C, D, h, w, R / (h + 1), depth_min, depth_max,
               log_range, mode};
  const int nbins = B * d.V * h * w;
  const auto* idx = static_cast<const int32_t*>(view_idx);
  const auto* pts = static_cast<const float*>(p2d);
  const auto* sel = static_cast<const uint8_t*>(selected);
  auto* cnt = static_cast<int*>(counts);
  auto* off = static_cast<int*>(offsets);
  auto* pos = static_cast<int*>(within);
  auto* df = static_cast<float*>(d_f);
  auto* rec = static_cast<float4*>(records);
  auto* slot_bins = static_cast<int*>(bins_of_slots);
  auto* slot_keys = static_cast<int*>(keys);
  auto* part = static_cast<float*>(partial);
  auto* head = static_cast<float*>(heads);
  auto* wide = static_cast<int*>(wide_points);

  int* found_on_card = nullptr;
  if (cudaHostGetDevicePointer(reinterpret_cast<void**>(&found_on_card),
                               found, 0) != cudaSuccess)
    return (int)cudaErrorInvalidValue;

  const long long ranks = (long long)B * N * K;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (ranks + kCountThreads - 1) / kCountThreads;
  const unsigned count_blocks =
      (unsigned)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  launches.add(count_kernel, "count_kernel", kCountThreads, 0);
  count_kernel<<<count_blocks, kCountThreads, 0, s>>>(idx, pts, sel, cnt, pos,
                                                      d);
  int code = (int)cudaGetLastError();
  if (code) return code;
  launches.add(scan_kernel, "scan_kernel", kScanThreads, 0);
  scan_kernel<<<1, kScanThreads, 0, s>>>(cnt, off, nbins, found_on_card);
  if ((code = (int)cudaGetLastError())) return code;
  if (capacity > 0) {
    // Each bin's places in ascending rank index.
    launches.add(keys_kernel, "keys_kernel", kCountThreads, 0);
    keys_kernel<<<count_blocks, kCountThreads, 0, s>>>(idx, pts, sel, off, pos,
                                                       slot_keys, capacity, d);
    if ((code = (int)cudaGetLastError())) return code;
    launches.add(order_bins_kernel, "order_bins_kernel", kOrderThreads, 0);
    order_bins_kernel<<<16 * sms, kOrderThreads, 0, s>>>(slot_keys, off,
                                                         nbins, capacity, pos);
    if ((code = (int)cudaGetLastError())) return code;
  }
  const auto* dep = static_cast<const float*>(depth);
  if (dtype == 0)
    code = launch_ranks_mode<float>(mode, stack, idx, pts, sel, dep, g_stats,
                                    off, pos, df, rec, slot_bins, wide,
                                    cnt + nbins, capacity, d, sms, s);
  else if (dtype == 1)
    code = launch_ranks_mode<__nv_bfloat16>(
        mode, stack, idx, pts, sel, dep, g_stats, off, pos, df, rec,
        slot_bins, wide, cnt + nbins, capacity, d, sms, s);
  else
    code = launch_ranks_mode<__half>(mode, stack, idx, pts, sel, dep,
                                     g_stats, off, pos, df, rec, slot_bins,
                                     wide, cnt + nbins, capacity, d, sms, s);
  if (code) return code;
  if (capacity > 0) {
    // A block per kChunk slots of the capacity.
    const unsigned blocks = (unsigned)((capacity + kChunk - 1) / kChunk);
    const int run_threads = (feature_warps + score_warps) * 32;
    launches.add(runs_kernel, "runs_kernel", run_threads, 0);
    runs_kernel<<<blocks, run_threads, 0, s>>>(df, rec, slot_bins, off, part,
                                               head, nbins, capacity,
                                               feature_warps, d);
    if ((code = (int)cudaGetLastError())) return code;
  }
  if (dtype == 0)
    return launch_fold<float>(part, head, off, grad, capacity, d, s);
  if (dtype == 1)
    return launch_fold<__nv_bfloat16>(part, head, off, grad, capacity, d, s);
  return launch_fold<__half>(part, head, off, grad, capacity, d, s);
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int lift_topk_bwd_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
