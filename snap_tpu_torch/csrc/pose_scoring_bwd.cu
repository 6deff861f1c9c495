// B7: the backward of B4, the RANSAC pose scores' gradient in the per-point
// score maps.
//
// Replaces the VJP that JAX's autodiff takes of snap_tpu/models/
// pose_estimation.py:_pose_scoring_block (a scatter-add, the transpose of
// its take_along_axis reads; there is no hand-written VJP).
//
// Inputs, per example b: the scores' cotangent g [B, P] (f32); the poses
// angle [B, P], t [B, P, 2] (f32); query points xy [B, N, 2] in meters;
// valid_points [B, N] and valid_map [B, H, W] (bool, one byte each). Output
// d_sim [B, N, H, W] (f32), every entry written. For each pose p and point
// n, as B4 (csrc/pose_scoring.cu) forms them, bit for bit:
//   uv = (R(angle) xy[n] + t) / cell_size
//   in_bounds = 0 <= uv < (H, W)
//   pts = clip(uv - 0.5, 0, (H, W) - 1); lower = floor(pts)
//   upper = min(lower + 1, (H, W) - 1); frac = pts - lower
// and d_sim[b, n, u_a, v_c] += (w_u[a] w_v[c]) g[b, p] for the four taps,
// where valid_points[n] (and, with mask_out_of_bounds, in_bounds and the
// four consulted cells of valid_map) keep the pose. Each added value is
// the reference's to the bit.
//
// Summation order: each entry of d_sim is the left fold from +0.0, over
// the runs of 32 consecutive poses (p / 32) in ascending order, of each
// run's left fold from +0.0 of its contributions to the entry in ascending
// pose, a pose's taps in the order (lower, lower), (lower, upper), (upper,
// lower), (upper, upper); models/pose_estimation.py:pose_scoring_bwd_plain
// computes the same, so d_sim is the same on every run and for any launch
// configuration. A contribution that is +-0 changes no such fold and is
// skipped: a pose whose g is 0, and a tap whose weight is 0. The latter
// covers the border, where upper == lower and two taps fall on one cell:
// the upper tap's frac is then 0. So a pose's nonzero taps lie on distinct
// cells. Where g is not finite, points and poses that keep drops get 0
// here and NaN in the plain version (g * 0); either way that example's
// gradient is not finite.
//
// What bounds it on an H100: the output, 714.5 MB at the training shape
// (batch 2, 4,652 in-FoV points, 120 x 160 cells): 0.213 ms at 3.35 TB/s.
// The arithmetic, 10,001 poses x 4,652 points x 2 examples = 93M (pose,
// point) pairs of ~42 f32 operations, is ~0.06 ms at the f32 rate.
//
// Design: one block per (point, example) holds that point's H x W gradient
// in shared memory (76.8 KB at 120 x 160: two blocks per SM). The four
// taps of a pose lie on rows of both parities and columns of both
// parities, so the cells of each parity class (row & 1, col & 1) take
// exactly one tap of every pose. Each class has one owner, a consumer warp
// (warps 0-3), which alone adds into its cells; the other 12 warps produce.
// Per tile of 384 poses each producer warp takes a run of 32, a pose a
// lane: it forms the pose's taps (cos, sin and t from a first launch, cosf
// and sinf as B4 takes them) and writes each tap's (cell, value) into its
// class's slot for that pose, -1 for none. Where two of the run's taps
// share a cell (a bit per cell of the class in the warp's own marks, set
// with atomicOr, finds them), the first lane of the cell folds their
// values in registers, in lane order, and the others' slots go empty: the
// run's fold. The owner then adds its class's slots onto its cells one run
// at a time, in pose order; the 32 slots of a run hold distinct cells, so
// each lane adds its own with one load and store. (Ordering the repeats on
// the owner's side instead, with __match_any_sync on every 32 slots or on
// those the marks flag, took 1.5-2.8x the time of shared-memory atomics in
// no fixed order, PERF.md section 6: the owners' chains of dependent adds
// bound the call, and the training call's poses cluster.) Two tiles of
// slots alternate, so the producers form tile j + 1 while the owners fold
// tile j, with one block barrier between. The block zeroes its map at
// the start and writes it out with 16-byte stores at the end; a block
// whose point is invalid writes zeros only. There are no float atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

constexpr int kThreads = 512;
constexpr int kClasses = 4;  // warps 0-3: the owners of (row & 1, col & 1)
constexpr int kTile = kThreads - 32 * kClasses;  // poses a tile: 384
constexpr int kChunks = kTile / 32;
constexpr int kPrepThreads = 256;
constexpr float kTwo23 = 8388608.f;
constexpr int kTwo23Bits = 0x4B000000;  // __float_as_int(2^23)
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int B, P, N, H, W;
  float cell;
};

// a / b rounded to nearest, given r = RN(1 / b) (Markstein), as B4.
__device__ inline float div_rn(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-b, q, a), r, q);
}

// poses[i] = (cos, sin, t0, t1) of pose i of all B x P.
__global__ void __launch_bounds__(kPrepThreads) pose_prep_kernel(
    const float* __restrict__ angle, const float* __restrict__ trans,
    float4* __restrict__ poses, long long total) {
  const long long i = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  if (i >= total) return;
  const float a = angle[i];
  poses[i] = make_float4(cosf(a), sinf(a), trans[2 * i], trans[2 * i + 1]);
}

__device__ inline bool cell_valid(const uint32_t* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// The map in shared memory is class-major: class k's cells (row, col) at
// k * plane + (row >> 1) * pitch + (col >> 1), each class a (H + 1) / 2 x
// pitch block. The pitch, (W + 1) / 2 rounded up to an even number and 2
// more, puts the cells of a cluster of poses on distinct banks.
__host__ __device__ inline int pitch(int W) {
  return (((W + 1) >> 1) + 2) & ~1;
}
__host__ __device__ inline int plane(int H, int W) {
  return ((H + 1) >> 1) * pitch(W);
}
// Words of one producer warp's marks: a bit per cell of a class.
__host__ __device__ inline int mark_words(int H, int W) {
  return (plane(H, W) + 31) >> 5;
}

// A producer warp's lanes that share a cell of one class (`seen`: at
// least one lane of each such cell, the others' first): the first lane of
// each cell takes the left fold from +0.0 of their values in lane order,
// all such cells at once, and the others drop theirs (cell -1).
__device__ inline int2 fold_repeats(int cell, float value, unsigned seen) {
  unsigned group = 0u;  // the lanes on this lane's cell, where it repeats
  do {
    const int held = __shfl_sync(kFull, cell, __ffs(seen) - 1);
    const unsigned on = __ballot_sync(kFull, cell >= 0 && cell == held);
    seen &= ~on;
    if (cell >= 0 && cell == held) group = on;
  } while (seen);
  const int lane = threadIdx.x & 31;
  const bool lead = cell >= 0 && (group & ((1u << lane) - 1u)) == 0u;
  float sum = __fadd_rn(0.f, value);
  unsigned rest = lead ? group & (group - 1u) : 0u;  // the later lanes
  while (__any_sync(kFull, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const float next = __shfl_sync(kFull, value, src);
    if (rest) {
      sum = __fadd_rn(sum, next);
      rest &= rest - 1u;
    }
  }
  return make_int2(lead ? cell : -1, __float_as_int(sum));
}

// A producer warp's 32 poses (one a lane, a run of 32 consecutive poses):
// each pose's tap in each class k = (row & 1) * 2 + (col & 1) into its
// slot (slots[k * kTile]: the cell's place in the map, or -1 where the
// pose is dropped or the tap's weight is 0, and the value), the taps of
// the run that share a cell folded into one slot (fold_repeats). The
// warp's marks (one bit per cell of a class, set with atomicOr and cleared
// again) tell whether any do.
template <bool kMask>
__device__ inline void produce(int2* slots, unsigned* marks, float gp,
                               float4 pose, float x, float y, const Shape& s,
                               float rcp, const uint32_t* vbits) {
  int lu = 0, lv = 0;
  float fu = 0.f, fv = 0.f;
  bool keep = false;
  if (gp != 0.f) {
    const float hf = (float)s.H, wf = (float)s.W;
    // R(angle) xy + t: (c x + (-s) y) == c x - s y, bit for bit (B4's).
    float u = __fadd_rn(pose.z, __fsub_rn(__fmul_rn(pose.x, x),
                                          __fmul_rn(pose.y, y)));
    float v = __fadd_rn(pose.w, __fadd_rn(__fmul_rn(pose.y, x),
                                          __fmul_rn(pose.x, y)));
    u = div_rn(u, s.cell, rcp);
    v = div_rn(v, s.cell, rcp);
    const float pu = fminf(fmaxf(__fsub_rn(u, 0.5f), 0.f), hf - 1.f);
    const float pv = fminf(fmaxf(__fsub_rn(v, 0.5f), 0.f), wf - 1.f);
    // floor(p) for 0 <= p < 2^23: (p + 2^23 rounded down) - 2^23.
    const float bu = __fadd_rd(pu, kTwo23), bv = __fadd_rd(pv, kTwo23);
    fu = __fsub_rn(pu, __fsub_rn(bu, kTwo23));
    fv = __fsub_rn(pv, __fsub_rn(bv, kTwo23));
    lu = __float_as_int(bu) - kTwo23Bits;
    lv = __float_as_int(bv) - kTwo23Bits;
    keep = true;
    if (kMask) {
      const int r0 = lu * s.W, r1 = min(lu + 1, s.H - 1) * s.W;
      const int c0 = lv, c1 = min(lv + 1, s.W - 1);
      keep = u >= 0.f && u < hf && v >= 0.f && v < wf &&
             cell_valid(vbits, r0 + c0) && cell_valid(vbits, r0 + c1) &&
             cell_valid(vbits, r1 + c0) && cell_valid(vbits, r1 + c1);
    }
  }
  const float wu0 = __fsub_rn(1.f, fu), wv0 = __fsub_rn(1.f, fv);
  const int row_pitch = pitch(s.W), class_plane = plane(s.H, s.W);
#pragma unroll
  for (int k = 0; k < kClasses; ++k) {
    // The class's tap: lower or upper row (a) and column (c), whichever
    // has the class's parity. An upper tap past the border (the clamped
    // one) has frac 0, so weight 0, and is left out.
    const int a = ((k >> 1) ^ lu) & 1, c = (k ^ lv) & 1;
    const float weight = __fmul_rn(a ? fu : wu0, c ? fv : wv0);
    const bool active = keep && weight != 0.f;
    const int row = lu + a, col = lv + c;
    const int mark = (row >> 1) * row_pitch + (col >> 1);
    const unsigned bit = 1u << (mark & 31);
    bool seen = false;
    if (active) seen = (atomicOr(marks + (mark >> 5), bit) & bit) != 0u;
    int2 slot = make_int2(active ? k * class_plane + mark : -1,
                          __float_as_int(__fmul_rn(weight, gp)));
    const unsigned repeats = __ballot_sync(kFull, seen);
    if (repeats) slot = fold_repeats(slot.x, __int_as_float(slot.y), repeats);
    slots[k * kTile] = slot;
    if (active) marks[mark >> 5] = 0u;
    __syncwarp();
  }
}

// The owner warp adds 32 slots (one run of 32 poses; no two on one cell)
// onto its cells.
__device__ inline void commit(float* map, int2 slot) {
  if (slot.x >= 0)
    map[slot.x] = __fadd_rn(map[slot.x], __int_as_float(slot.y));
  __syncwarp();
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads, 2) pose_scoring_bwd_kernel(
    const float* __restrict__ g,               // [B, P]
    const float4* __restrict__ poses,          // [B, P]
    const float* __restrict__ xy,              // [B, N, 2]
    const uint8_t* __restrict__ valid_points,  // [B, N]
    const uint8_t* __restrict__ valid_map,     // [B, H, W]
    float* __restrict__ d_sim,                 // [B, N, H, W]
    Shape s, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* map = reinterpret_cast<float*>(smem);
  const int cells = s.H * s.W;
  const int row_pitch = pitch(s.W), class_plane = plane(s.H, s.W);
  // Two tiles of slots [2][kClasses][kTile], the producer warps' marks,
  // then the valid map's bits.
  int2* slots = reinterpret_cast<int2*>(map + kClasses * class_plane);
  unsigned* marks = reinterpret_cast<unsigned*>(slots + 2 * kClasses * kTile);
  const int words = mark_words(s.H, s.W);
  uint32_t* vbits = marks + kChunks * words;
  const int tid = threadIdx.x, n = blockIdx.x, b = blockIdx.y;
  const int warp = tid >> 5, lane = tid & 31;
  const long long q = (long long)b * s.N + n;
  float* out = d_sim + q * cells;

  if (!valid_points[q]) {  // block-uniform: nothing reaches this map
    if (vec) {
      float4* out4 = reinterpret_cast<float4*>(out);
      for (int i = tid; i < cells / 4; i += kThreads)
        out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int i = tid; i < cells; i += kThreads) out[i] = 0.f;
    }
    return;
  }
  float4* map4 = reinterpret_cast<float4*>(map);  // 4 planes: a multiple
  for (int i = tid; i < class_plane; i += kThreads)  // of 16 bytes
    map4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kChunks * words; i += kThreads) marks[i] = 0u;
  if (kMask) {
    const uint8_t* vm = valid_map + (long long)b * cells;
    for (int word = warp; word * 32 < cells; word += kThreads / 32) {
      const int c = word * 32 + lane;
      const unsigned bits = __ballot_sync(kFull, c < cells && vm[c]);
      if (lane == 0) vbits[word] = bits;
    }
  }

  const float x = xy[2 * q], y = xy[2 * q + 1];
  const float rcp = __frcp_rn(s.cell);
  const float* gb = g + (long long)b * s.P;
  const float4* pb = poses + (long long)b * s.P;
  const int tiles = (s.P + kTile - 1) / kTile;
  const int j = tid - 32 * kClasses;  // a producer's pose in its tile
  float gp = 0.f;
  float4 pose = make_float4(0.f, 0.f, 0.f, 0.f);
  if (warp >= kClasses && j < s.P) {
    gp = gb[j];
    pose = pb[j];
  }
  __syncthreads();

  for (int tile = 0; tile <= tiles; ++tile) {
    if (warp >= kClasses) {
      if (tile < tiles) {
        produce<kMask>(slots + (tile & 1) * kClasses * kTile + j,
                       marks + (warp - kClasses) * words, gp, pose, x, y, s,
                       rcp, vbits);
        const int next = (tile + 1) * kTile + j;  // the next tile's, early
        gp = 0.f;
        if (next < s.P) {
          gp = gb[next];
          pose = pb[next];
        }
      }
    } else if (tile > 0) {
      const int2* own =
          slots + (((tile - 1) & 1) * kClasses + warp) * kTile + lane;
      int2 slot[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) slot[c] = own[32 * c];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) commit(map, slot[c]);
    }
    __syncthreads();
  }

  // Row r's cells from classes (r & 1, 0) and (r & 1, 1), alternately.
  if (vec) {  // W % 4 == 0: 4 cells from 2 of each class
    float4* out4 = reinterpret_cast<float4*>(out);
    const int quads = s.W / 4;
    for (int i = tid; i < cells / 4; i += kThreads) {
      const int r = i / quads, c = 2 * (i - r * quads);
      const float* even =
          map + (r & 1) * 2 * class_plane + (r >> 1) * row_pitch + c;
      const float2 e = *reinterpret_cast<const float2*>(even);
      const float2 o = *reinterpret_cast<const float2*>(even + class_plane);
      out4[i] = make_float4(e.x, o.x, e.y, o.y);
    }
  } else {
    for (int i = tid; i < cells; i += kThreads) {
      const int r = i / s.W, c = i - r * s.W;
      out[i] = map[((r & 1) * 2 + (c & 1)) * class_plane +
                   (r >> 1) * row_pitch + (c >> 1)];
    }
  }
}

template <bool kMask>
int launch(const Shape& s, const float* g, const float4* poses,
           const float* xy, const uint8_t* valid_points,
           const uint8_t* valid_map, float* d_sim, int vec, int smem_bytes,
           cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      pose_scoring_bwd_kernel<kMask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (set != cudaSuccess) return (int)set;
  launches.add(pose_scoring_bwd_kernel<kMask>, "pose_scoring_bwd_kernel",
               kThreads, smem_bytes);
  pose_scoring_bwd_kernel<kMask>
      <<<dim3((unsigned)s.N, (unsigned)s.B), kThreads, smem_bytes, stream>>>(
          g, poses, xy, valid_points, valid_map, d_sim, s, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// poses: [B, P, 4] f32 scratch. smem: one block's dynamic shared memory:
// the point's f32 map (4 planes), two tiles of slots (4 x 384 of 8 bytes
// each), the producer warps' marks and, with the mask, the example's valid
// map as bits (ops/kernels.py:pose_scoring_bwd_smem_bytes, which checks
// that it fits).
// d_sim comes from torch.empty, so it is 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int pose_scoring_bwd(const void* g, const void* angle,
                                const void* trans, const void* xy,
                                const void* valid_points,
                                const void* valid_map, void* d_sim,
                                void* poses, int B, int P, int N, int H,
                                int W, float cell, int mask, int smem,
                                void* stream) {
  launches.clear();
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s{B, P, N, H, W, cell};
  auto* pose4 = static_cast<float4*>(poses);
  const long long total = (long long)B * P;
  if (total > 0) {
    launches.add(pose_prep_kernel, "pose_prep_kernel", kPrepThreads, 0);
    pose_prep_kernel<<<(unsigned)((total + kPrepThreads - 1) / kPrepThreads),
                       kPrepThreads, 0, st>>>(
        static_cast<const float*>(angle), static_cast<const float*>(trans),
        pose4, total);
    const cudaError_t code = cudaGetLastError();
    if (code != cudaSuccess) return (int)code;
  }
  const int vec = W % 4 == 0 ? 1 : 0;
  const auto* gp = static_cast<const float*>(g);
  const auto* p = static_cast<const float*>(xy);
  const auto* vp = static_cast<const uint8_t*>(valid_points);
  const auto* vm = static_cast<const uint8_t*>(valid_map);
  auto* out = static_cast<float*>(d_sim);
  return mask ? launch<true>(s, gp, pose4, p, vp, vm, out, vec, smem, st)
              : launch<false>(s, gp, pose4, p, vp, vm, out, vec, smem, st);
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int pose_scoring_bwd_occupancy(KernelOccupancy* out,
                                          int capacity) {
  return launches.report(out, capacity);
}
