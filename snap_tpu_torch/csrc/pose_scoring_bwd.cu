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
// four consulted cells of valid_map) keep the pose. Where upper == lower
// at the border both taps add into one cell, as in the reference (the
// upper tap's weight is then 0). Each added value is the reference's to the
// bit; the sums run in another order.
//
// Summation order: the four taps of every pose of one point are added with
// shared-memory f32 atomics, in an order that changes from run to run, so
// d_sim differs between runs (and from the plain version) by rounding
// (ROADMAP C19). A pose whose g is 0 adds nothing and is skipped. Where g
// is not finite, points and poses that keep drops get 0 here and NaN in
// the reference (g * 0); either way the step's gradients are not finite.
//
// What bounds it on an H100: the output, 714.5 MB at the training shape
// (batch 2, 4,652 in-FoV points, 120 x 160 cells): 0.213 ms at 3.35 TB/s.
// The arithmetic, 10,001 poses x 4,652 points x 2 examples = 93M (pose,
// point) pairs of ~42 f32 operations and 4 shared atomics, is ~0.06 ms at
// the f32 rate.
//
// Design: one block per (point, example), holding that point's H x W
// gradient in shared memory (76.8 KB at 120 x 160, plus the example's
// valid_map with the mask: two blocks per SM). The block zeroes its map,
// its threads stride over all P poses (a warp takes 32 consecutive ones)
// and add the four taps with shared-memory atomics (no global atomics),
// then it writes the map out with 16-byte stores. A block whose point is
// invalid writes zeros only. A first launch forms each pose's (cos, sin,
// t0, t1) once (cosf and sinf as B4 takes them), which every block of the
// example then reads from L2 (160 KB an example): re-reading them costs
// ~1.9 GB of L2 traffic a call at the training shape. Contended cells
// (poses clustered near the GT) serialize the atomics of a warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

constexpr int kThreads = 512;
constexpr int kPrepThreads = 256;
constexpr float kTwo23 = 8388608.f;
constexpr int kTwo23Bits = 0x4B000000;  // __float_as_int(2^23)

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
  uint8_t* vmap = smem + (long long)cells * sizeof(float);
  const int tid = threadIdx.x, n = blockIdx.x, b = blockIdx.y;
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
  if (vec) {
    float4* map4 = reinterpret_cast<float4*>(map);
    for (int i = tid; i < cells / 4; i += kThreads)
      map4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = tid; i < cells; i += kThreads) map[i] = 0.f;
  }
  if (kMask) {
    const uint8_t* vm = valid_map + (long long)b * cells;
    for (int i = tid; i < cells; i += kThreads) vmap[i] = vm[i];
  }
  __syncthreads();

  const float x = xy[2 * q], y = xy[2 * q + 1];
  const float rcp = __frcp_rn(s.cell);
  const float hf = (float)s.H, wf = (float)s.W;
  const float hmax = hf - 1.f, wmax = wf - 1.f;
  const float* gb = g + (long long)b * s.P;
  const float4* pb = poses + (long long)b * s.P;
  for (int p = tid; p < s.P; p += kThreads) {
    const float gp = gb[p];
    if (gp == 0.f) continue;
    const float4 pose = pb[p];
    // R(angle) xy + t: (c x + (-s) y) == c x - s y, bit for bit (B4's).
    float u = __fadd_rn(pose.z, __fsub_rn(__fmul_rn(pose.x, x),
                                          __fmul_rn(pose.y, y)));
    float v = __fadd_rn(pose.w, __fadd_rn(__fmul_rn(pose.y, x),
                                          __fmul_rn(pose.x, y)));
    u = div_rn(u, s.cell, rcp);
    v = div_rn(v, s.cell, rcp);
    const float pu = fminf(fmaxf(__fsub_rn(u, 0.5f), 0.f), hmax);
    const float pv = fminf(fmaxf(__fsub_rn(v, 0.5f), 0.f), wmax);
    // floor(p) for 0 <= p < 2^23: (p + 2^23 rounded down) - 2^23.
    const float bu = __fadd_rd(pu, kTwo23), bv = __fadd_rd(pv, kTwo23);
    const float fu = __fsub_rn(pu, __fsub_rn(bu, kTwo23));
    const float fv = __fsub_rn(pv, __fsub_rn(bv, kTwo23));
    const int lu = __float_as_int(bu) - kTwo23Bits;
    const int lv = __float_as_int(bv) - kTwo23Bits;
    const int r0 = lu * s.W, r1 = min(lu + 1, s.H - 1) * s.W;
    const int c0 = lv, c1 = min(lv + 1, s.W - 1);
    if (kMask) {
      const bool keep = u >= 0.f && u < hf && v >= 0.f && v < wf &&
                        (vmap[r0 + c0] & vmap[r0 + c1] & vmap[r1 + c0] &
                         vmap[r1 + c1]);
      if (!keep) continue;
    }
    const float wu0 = __fsub_rn(1.f, fu), wv0 = __fsub_rn(1.f, fv);
    atomicAdd(map + r0 + c0, __fmul_rn(__fmul_rn(wu0, wv0), gp));
    atomicAdd(map + r0 + c1, __fmul_rn(__fmul_rn(wu0, fv), gp));
    atomicAdd(map + r1 + c0, __fmul_rn(__fmul_rn(fu, wv0), gp));
    atomicAdd(map + r1 + c1, __fmul_rn(__fmul_rn(fu, fv), gp));
  }
  __syncthreads();

  if (vec) {
    const float4* map4 = reinterpret_cast<const float4*>(map);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = tid; i < cells / 4; i += kThreads) out4[i] = map4[i];
  } else {
    for (int i = tid; i < cells; i += kThreads) out[i] = map[i];
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

// poses: [B, P, 4] f32 scratch. smem: one block's dynamic shared memory,
// the point's f32 map and, with the mask, the example's valid_map
// (ops/kernels.py:pose_scoring_bwd_smem_bytes, which checks that it fits).
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
  const int vec = (H * W) % 4 == 0 ? 1 : 0;
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
