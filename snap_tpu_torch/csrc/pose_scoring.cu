// B4: score RANSAC pose hypotheses by bilinear reads of per-point score maps.
//
// Replaces snap_tpu/models/pose_estimation.py:_pose_scoring_block (a hand-
// shaped XLA formulation that pose_scoring_many tiles over chunks of 4096
// poses, materializing [chunk, N] index and weight tensors per tap).
//
// Inputs, per example b: poses angle [B, P], t [B, P, 2] (f32); per-point
// score maps sim [B, N, H, W] (f32); query points xy [B, N, 2] in meters;
// valid_points [B, N] and valid_map [B, H, W] (bool, one byte each). For
// each pose p and point n, as the reference does:
//   uv = (R(angle) xy[n] + t) / cell_size
//   in_bounds = 0 <= uv < (H, W)
//   pts = clip(uv - 0.5, 0, (H, W) - 1); lower = floor(pts)
//   upper = min(lower + 1, (H, W) - 1); frac = pts - lower
//   term = sum over taps (a, c) of w_u[a] w_v[c] sim[n, u_a, v_c]
// and out[b, p] = sum over n of valid_points[n] * term, where with
// mask_out_of_bounds the term also needs in_bounds and all four consulted
// cells of valid_map; without it, out-of-bounds reads clamp and count.
//
// Every f32 operation of a term is rounded as the reference rounds it, in
// its order, so nvcc fuses nothing into an FMA: the per-(pose, point) term
// is the plain version's to the bit (cos and sin are libdevice's, as
// torch.cos on the card), and the sum over n differs only by order. Three
// rewrites keep the bits and save instructions:
//   - the division by the cell is Markstein's sequence q = a * r,
//     q += (a - cell q) r with r = RN(1 / cell): correctly rounded (the FMA
//     remainder is exact), as __fdiv_rn, in 3 instructions instead of ~10;
//   - floor(pts) for 0 <= pts < 2^23 is (pts + 2^23 rounded down) - 2^23,
//     two adds at the full rate instead of conversions at a sixteenth of it;
//   - the upper tap reads a zero padding column and row where the reference
//     clamps it: there its weight is exactly 0 and 0 * x == 0 * 0 for finite
//     x. With the mask, the staged valid_map repeats its last row and column
//     in the padding, so the four consulted cells are the reference's.
//
// What bounds it on an H100: instruction issue. The score maps are 1.43 GB
// at the eval shape (batch 4, 4,652 points: ~0.43 ms at 3.35 TB/s); the
// terms are 20,001 (sampled) or 68,921 (41^3 refinement lattice) poses x
// 4,652 points x 4 examples, 0.37 G and 1.28 G (pose, point) pairs, and a
// pair costs ~50 instructions here (~100 in the first design, which read
// the taps with scattered 4-byte loads from L2): ~0.6 and ~2.2 ms at
// 29.7 T lane-instructions/s. The four taps are shared-memory reads, with
// bank conflicts where the lanes' cells share a bank (~3.5-way for the
// sampled poses, ~2.5-way along the lattice).
//
// Design: a grid of (pose tile, point group, example). A block of
// kThreads threads holds kPoseTile poses (kPosesPerThread per thread, their
// cos, sin, t and sum in registers) and walks the valid points of its group
// in order. Each point's map is copied into shared memory (cp.async, 16
// bytes a lane, rows padded to a stride of W + 1 rounded up to 4 floats)
// while the block scores the previous point's map: two buffers, 158.8 KB at
// 120 x 160, so one block per SM. Every tap is a shared-memory read, and
// the tiles of one group run side by side (tile is the grid's fastest axis)
// and share each map in L2. Only the part of a map that the block's poses
// can reach is copied (its footprint: the poses' angle and translation
// ranges applied to the point, with a margin): the whole map for sampled
// poses, which cover the map; for a tile of the refinement lattice (+-4 m,
// +-5 degrees) about 60 x 60 of the 120 x 160 cells at a point 25 m away.
// The block writes its group's partial sums [B, G, P]; a second launch
// adds the G partials of each pose in order (none when G == 1). No
// atomics: the result is deterministic. The wrapper picks G so that the
// grid fills whole waves (ops/kernels.py:pose_scoring_plan).
// Block shapes of 512 x 14, 896 x 8 and 1024 x 6 (threads x poses) were
// measured slower than 768 x 9 on an H100.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

// Threads per block and poses per thread (ops/kernels.py:POSE_TILE plans
// with their product).
constexpr int kThreads = 768;
constexpr int kPosesPerThread = 9;
constexpr int kPoseTile = kThreads * kPosesPerThread;
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwo23 = 8388608.f;
constexpr int kTwo23Bits = 0x4B000000;  // __float_as_int(2^23)

struct Shape {
  int B, P, N, H, W;
  int S;      // floats per staged map row: W + 1 rounded up to 4
  int group;  // points per group
  int G;      // groups
  float cell;
  int vec;    // maps are copied 16 bytes at a time (W % 4 == 0, aligned)
};

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group of this thread is in flight.
__device__ inline void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows box.x..box.y and columns box.z..box.w of one point's H x W map into
// a staged buffer of row stride S (a warp per row); the rest of the buffer
// is left as it is. With 16-byte copies box.z is a multiple of 4.
__device__ inline void stage_map(float* dst, const float* src,
                                 const Shape& s, short4 box) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (s.vec) {
    for (int r = box.x + warp; r <= box.y; r += kThreads / 32)
      for (int c = (box.z >> 2) + lane; c <= (box.w >> 2); c += 32)
        cp_async16(dst + r * s.S + 4 * c, src + (long long)r * s.W + 4 * c);
  } else {
    for (int r = box.x + warp; r <= box.y; r += kThreads / 32)
      for (int c = box.z + lane; c <= box.w; c += 32)
        cp_async4(dst + r * s.S + c, src + (long long)r * s.W + c);
  }
}

// The rows (x..y) and columns (z..w) of a point's map that the taps of a
// block's poses can reach: bounds = the poses' angle, t0 and t1 ranges.
// Within an angle range of less than a radian the rotated point lies on an
// arc within its chord's box grown by the sagitta; past it, within the
// circle of its radius. Two cells of margin cover the rounding.
__device__ inline short4 footprint(float x, float y, const float* bounds,
                                   const Shape& s) {
  const float r = sqrtf(x * x + y * y);
  const float span = bounds[1] - bounds[0];
  float x_lo = -r, x_hi = r, y_lo = -r, y_hi = r;
  if (span < 1.f) {
    float s0, c0, s1, c1;
    sincosf(bounds[0], &s0, &c0);
    sincosf(bounds[1], &s1, &c1);
    const float xa = c0 * x - s0 * y, ya = s0 * x + c0 * y;
    const float xb = c1 * x - s1 * y, yb = s1 * x + c1 * y;
    const float sag = r * (1.f - cosf(0.5f * span));
    x_lo = fminf(xa, xb) - sag;
    x_hi = fmaxf(xa, xb) + sag;
    y_lo = fminf(ya, yb) - sag;
    y_hi = fmaxf(ya, yb) + sag;
  }
  // lower = floor(clip(uv - 0.5, 0, size - 1)); the taps reach lower + 1.
  const auto lower = [](float uv, int size) {
    return (int)floorf(fminf(fmaxf(uv - 0.5f, 0.f), (float)(size - 1)));
  };
  const int r0 = max(lower((bounds[2] + x_lo) / s.cell, s.H) - 2, 0);
  const int r1 = min(lower((bounds[3] + x_hi) / s.cell, s.H) + 3, s.H - 1);
  int c0 = max(lower((bounds[4] + y_lo) / s.cell, s.W) - 2, 0);
  const int c1 = min(lower((bounds[5] + y_hi) / s.cell, s.W) + 3, s.W - 1);
  if (s.vec) c0 &= ~3;
  return make_short4((short)r0, (short)r1, (short)c0, (short)c1);
}

// a / b rounded to nearest, given r = RN(1 / b) (Markstein).
__device__ inline float div_rn(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-b, q, a), r, q);
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads, 1) pose_scoring_kernel(
    const float* __restrict__ angle,          // [B, P]
    const float* __restrict__ trans,          // [B, P, 2]
    const float* __restrict__ sim,            // [B, N, H, W]
    const float* __restrict__ xy,             // [B, N, 2]
    const uint8_t* __restrict__ valid_points,  // [B, N]
    const uint8_t* __restrict__ valid_map,     // [B, H, W]
    float* __restrict__ dst,                  // [B, G, P] (or [B, P] if G == 1)
    Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int map_floats = (s.H + 1) * s.S;
  float* maps = reinterpret_cast<float*>(smem);  // 2 buffers
  uint8_t* vmap = smem + 2 * map_floats * sizeof(float);
  const int vmap_bytes = kMask ? (map_floats + 15) & ~15 : 0;
  float2* s_xy = reinterpret_cast<float2*>(vmap + vmap_bytes);
  short4* s_box = reinterpret_cast<short4*>(s_xy + s.group);
  int* s_idx = reinterpret_cast<int*>(s_box + s.group);
  __shared__ int s_count;
  __shared__ float s_bounds[kThreads / 32][6];

  const int tid = threadIdx.x, lane = tid & 31;
  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const long long hw = (long long)s.H * s.W;

  // Zero both buffers: the padding stays 0, the copies overwrite the rest.
  float4* all = reinterpret_cast<float4*>(maps);
  for (int i = tid; i < (2 * map_floats) / 4; i += kThreads)
    all[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kMask) {
    // valid_map with its last row and column repeated in the padding.
    const uint8_t* vm = valid_map + (long long)b * hw;
    for (int i = tid; i < map_floats; i += kThreads) {
      const int r = i / s.S, c = i - r * s.S;
      vmap[i] = vm[min(r, s.H - 1) * s.W + min(c, s.W - 1)];
    }
  }
  // The group's valid points, in order.
  const int n0 = g * s.group, n1 = min(s.N, n0 + s.group);
  if (tid < 32) {
    int count = 0;
    for (int i0 = n0; i0 < n1; i0 += 32) {
      const int i = i0 + lane;
      const long long q = (long long)b * s.N + i;
      const bool ok = i < n1 && valid_points[q];
      const unsigned bal = __ballot_sync(kFull, ok);
      if (ok) {
        const int slot = count + __popc(bal & ((1u << lane) - 1u));
        s_idx[slot] = i;
        s_xy[slot] = make_float2(xy[2 * q], xy[2 * q + 1]);
      }
      count += __popc(bal);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const int count = s_count;
  const float* sim_b = sim + (long long)b * s.N * hw;
  const short4 whole = make_short4(0, (short)(s.H - 1), 0, (short)(s.W - 1));
  if (count > 0) stage_map(maps, sim_b + s_idx[0] * hw, s, whole);
  cp_async_commit();

  // The thread's poses: constants and sums in registers.
  const float rcp = __frcp_rn(s.cell);
  const float hf = (float)s.H, wf = (float)s.W;
  const float hmax = hf - 1.f, wmax = wf - 1.f;
  float pc[kPosesPerThread], ps[kPosesPerThread];
  float pt0[kPosesPerThread], pt1[kPosesPerThread], acc[kPosesPerThread];
  // The block's poses' ranges: angle, t0, t1 (min, max each).
  float bounds[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, INFINITY,
                     -INFINITY};
#pragma unroll
  for (int p = 0; p < kPosesPerThread; ++p) {
    const int pose = tile * kPoseTile + p * kThreads + tid;
    const long long q = (long long)b * s.P + (pose < s.P ? pose : 0);
    const float a = angle[q];
    pc[p] = cosf(a);
    ps[p] = sinf(a);
    pt0[p] = trans[2 * q];
    pt1[p] = trans[2 * q + 1];
    acc[p] = 0.f;
    if (pose < s.P) {
      const float v[3] = {a, pt0[p], pt1[p]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bounds[2 * k] = fminf(bounds[2 * k], v[k]);
        bounds[2 * k + 1] = fmaxf(bounds[2 * k + 1], v[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; k += 2)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      bounds[k] = fminf(bounds[k], __shfl_xor_sync(kFull, bounds[k], off));
      bounds[k + 1] =
          fmaxf(bounds[k + 1], __shfl_xor_sync(kFull, bounds[k + 1], off));
    }
  if (lane == 0)
    for (int k = 0; k < 6; ++k) s_bounds[tid >> 5][k] = bounds[k];
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w)
    for (int k = 0; k < 6; k += 2) {
      bounds[k] = fminf(bounds[k], s_bounds[w][k]);
      bounds[k + 1] = fmaxf(bounds[k + 1], s_bounds[w][k + 1]);
    }
  // Each point's footprint under the block's poses: the part of its map
  // to stage (the first point's map is staged whole, above).
  for (int j = 1 + tid; j < count; j += kThreads)
    s_box[j] = footprint(s_xy[j].x, s_xy[j].y, bounds, s);
  __syncthreads();

  for (int j = 0; j < count; ++j) {
    if (j + 1 < count)
      stage_map(maps + ((j + 1) & 1) * map_floats,
                sim_b + s_idx[j + 1] * hw, s, s_box[j + 1]);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // map j is in its buffer, for every thread
    const float* map = maps + (j & 1) * map_floats;
    const float x = s_xy[j].x, y = s_xy[j].y;
#pragma unroll
    for (int p = 0; p < kPosesPerThread; ++p) {
      // R(angle) xy + t: (c x + (-s) y) == c x - s y, bit for bit.
      float u = __fadd_rn(pt0[p], __fsub_rn(__fmul_rn(pc[p], x),
                                            __fmul_rn(ps[p], y)));
      float v = __fadd_rn(pt1[p], __fadd_rn(__fmul_rn(ps[p], x),
                                            __fmul_rn(pc[p], y)));
      u = div_rn(u, s.cell, rcp);
      v = div_rn(v, s.cell, rcp);
      const float pu = fminf(fmaxf(__fsub_rn(u, 0.5f), 0.f), hmax);
      const float pv = fminf(fmaxf(__fsub_rn(v, 0.5f), 0.f), wmax);
      const float bu = __fadd_rd(pu, kTwo23), bv = __fadd_rd(pv, kTwo23);
      const float fu = __fsub_rn(pu, __fsub_rn(bu, kTwo23));
      const float fv = __fsub_rn(pv, __fsub_rn(bv, kTwo23));
      const int at = (__float_as_int(bu) - kTwo23Bits) * s.S +
                     (__float_as_int(bv) - kTwo23Bits);
      const float wu0 = __fsub_rn(1.f, fu), wv0 = __fsub_rn(1.f, fv);
      const float* m = map + at;
      float term = __fmul_rn(__fmul_rn(wu0, wv0), m[0]);
      term = __fadd_rn(term, __fmul_rn(__fmul_rn(wu0, fv), m[1]));
      term = __fadd_rn(term, __fmul_rn(__fmul_rn(fu, wv0), m[s.S]));
      term = __fadd_rn(term, __fmul_rn(__fmul_rn(fu, fv), m[s.S + 1]));
      if (kMask) {
        const uint8_t* vm = vmap + at;
        const bool keep = u >= 0.f && u < hf && v >= 0.f && v < wf &&
                          (vm[0] & vm[1] & vm[s.S] & vm[s.S + 1]);
        if (keep) acc[p] = __fadd_rn(acc[p], term);
      } else {
        acc[p] = __fadd_rn(acc[p], term);
      }
    }
    __syncthreads();  // every thread is done with map j's buffer
  }

  float* out = dst + ((long long)b * s.G + g) * s.P;
#pragma unroll
  for (int p = 0; p < kPosesPerThread; ++p) {
    const int pose = tile * kPoseTile + p * kThreads + tid;
    if (pose < s.P) out[pose] = acc[p];
  }
}

// out[b, p] = the sum over g of partial[b, g, p], g in order.
__global__ void __launch_bounds__(kSumThreads) sum_groups_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int B, int G,
    int P) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= (long long)B * P) return;
  const int b = (int)(i / P), p = (int)(i - (long long)b * P);
  const float* src = partial + (long long)b * G * P + p;
  float sum = 0.f;
  for (int g = 0; g < G; ++g) sum = __fadd_rn(sum, src[(long long)g * P]);
  out[i] = sum;
}

template <bool kMask>
int launch(const Shape& s, const float* angle, const float* trans,
           const float* sim, const float* xy, const uint8_t* valid_points,
           const uint8_t* valid_map, float* dst, int smem_bytes,
           cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      pose_scoring_kernel<kMask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((s.P + kPoseTile - 1) / kPoseTile),
                  (unsigned)s.G, (unsigned)s.B);
  launches.add(pose_scoring_kernel<kMask>, "pose_scoring_kernel", kThreads,
               smem_bytes);
  pose_scoring_kernel<kMask><<<grid, kThreads, smem_bytes, stream>>>(
      angle, trans, sim, xy, valid_points, valid_map, dst, s);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block: two staged maps, the staged
// valid_map (with the mask) and the group's point list (as
// ops/kernels.py:pose_scoring_smem_bytes, which checks that it fits).
int block_smem_bytes(int H, int W, int group, int mask) {
  const int S = (W + 1 + 3) & ~3;
  const int map_floats = (H + 1) * S;
  return 2 * map_floats * 4 + (mask ? (map_floats + 15) & ~15 : 0) +
         group * 20;
}

}  // namespace

// partial: [B, G, P] f32 scratch, unused when G == 1. Returns a cudaError_t
// (0 on success).
extern "C" int pose_scoring(const void* angle, const void* trans,
                            const void* sim, const void* xy,
                            const void* valid_points, const void* valid_map,
                            void* out, void* partial, int B, int P, int N,
                            int H, int W, float cell, int mask, int G,
                            int group, void* stream) {
  launches.clear();
  if (B <= 0 || P <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s{B, P, N, H, W, (W + 1 + 3) & ~3, group, G, cell,
          (W % 4 == 0 && reinterpret_cast<uintptr_t>(sim) % 16 == 0) ? 1 : 0};
  const int smem = block_smem_bytes(H, W, group, mask);
  float* dst = static_cast<float*>(G == 1 ? out : partial);
  const auto* a = static_cast<const float*>(angle);
  const auto* t = static_cast<const float*>(trans);
  const auto* m = static_cast<const float*>(sim);
  const auto* p = static_cast<const float*>(xy);
  const auto* vp = static_cast<const uint8_t*>(valid_points);
  const auto* vm = static_cast<const uint8_t*>(valid_map);
  const int code = mask ? launch<true>(s, a, t, m, p, vp, vm, dst, smem, st)
                        : launch<false>(s, a, t, m, p, vp, vm, dst, smem, st);
  if (code != 0 || G == 1) return code;
  const long long total = (long long)B * P;
  launches.add(sum_groups_kernel, "sum_groups_kernel", kSumThreads, 0);
  sum_groups_kernel<<<(unsigned)((total + kSumThreads - 1) / kSumThreads),
                      kSumThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), B, G, P);
  return (int)cudaGetLastError();
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int pose_scoring_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
