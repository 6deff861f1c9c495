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
// Every f32 operation is written with its _rn intrinsic, in the reference's
// order, so nvcc fuses nothing into an FMA: the per-(pose, point) term is
// the plain version's to the bit (cos and sin are libdevice's, as
// torch.cos on the card), and the sum over n differs only by order.
//
// Design: one thread per (example, pose), a sequential loop over the points
// in a fixed order (no atomics: deterministic). A block holds 128 poses of
// one example; the points' xy and validity are staged through shared memory
// in tiles, since every lane reads the same point at the same time. Within
// one point's map (77 KB at the flagship's 120 x 160 cells) neighbouring
// poses read nearby cells, most of all in grid refinement, whose offsets
// are a dense 0.2 m / 0.25 deg lattice, so the lanes of a warp share cache
// lines. B4 forms no [P, N] intermediate.
//
// What bounds it on an H100: at the eval shape the score maps are 1.43 GB
// (batch 4, 4,652 points) and are read once at most, ~0.43 ms at 3.35 TB/s;
// the ~45 f32 operations per (pose, point) make 88,922 poses x 4,652
// points x 4 examples ~74 GFLOP, ~1.1 ms at 67 TFLOP/s. The reads are
// scattered 4-byte loads (four per pair), served from L1/L2 when the lanes
// of a warp land near each other and from device memory when they do not
// (the sampled poses are spread over the whole map).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;

__global__ void pose_scoring_kernel(
    const float* __restrict__ angle,          // [B, P]
    const float* __restrict__ trans,          // [B, P, 2]
    const float* __restrict__ sim,            // [B, N, H, W]
    const float* __restrict__ xy,             // [B, N, 2]
    const uint8_t* __restrict__ valid_points,  // [B, N]
    const uint8_t* __restrict__ valid_map,     // [B, H, W]
    float* __restrict__ out,                  // [B, P]
    int P, int N, int H, int W, float cell, int mask) {
  __shared__ float s_x[kTile], s_y[kTile];
  __shared__ uint8_t s_valid[kTile];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < P;
  const long long pose = (long long)b * P + (active ? p : 0);
  const float a = angle[pose];
  const float c = cosf(a), s = sinf(a), ms = -s;
  const float t0 = trans[2 * pose], t1 = trans[2 * pose + 1];
  const float hf = (float)H, wf = (float)W;
  const long long hw = (long long)H * W;
  const float* sim_b = sim + (long long)b * N * hw;
  const uint8_t* vmap = valid_map + (long long)b * hw;
  float acc = 0.f;

  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int count = min(kTile, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const long long q = (long long)b * N + n0 + i;
      s_x[i] = xy[2 * q];
      s_y[i] = xy[2 * q + 1];
      s_valid[i] = valid_points[q];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < count; ++i) {
      if (!s_valid[i]) continue;  // the term is multiplied by 0
      const float x = s_x[i], y = s_y[i];
      float u = __fadd_rn(t0, __fadd_rn(__fmul_rn(c, x), __fmul_rn(ms, y)));
      float v = __fadd_rn(t1, __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y)));
      u = __fdiv_rn(u, cell);
      v = __fdiv_rn(v, cell);
      const bool in_bounds = u >= 0.f && u < hf && v >= 0.f && v < wf;
      if (mask && !in_bounds) continue;
      const float pu = fminf(fmaxf(__fsub_rn(u, 0.5f), 0.f), hf - 1.f);
      const float pv = fminf(fmaxf(__fsub_rn(v, 0.5f), 0.f), wf - 1.f);
      const int lu = (int)floorf(pu), lv = (int)floorf(pv);
      const int uu = min(lu + 1, H - 1), uv = min(lv + 1, W - 1);
      const float fu = __fsub_rn(pu, (float)lu);
      const float fv = __fsub_rn(pv, (float)lv);
      const float wu0 = __fsub_rn(1.f, fu), wv0 = __fsub_rn(1.f, fv);
      const int id00 = lu * W + lv, id01 = lu * W + uv;
      const int id10 = uu * W + lv, id11 = uu * W + uv;
      if (mask && !(vmap[id00] && vmap[id01] && vmap[id10] && vmap[id11]))
        continue;
      const float* map = sim_b + (long long)(n0 + i) * hw;
      float term = __fmul_rn(__fmul_rn(wu0, wv0), __ldg(map + id00));
      term = __fadd_rn(term, __fmul_rn(__fmul_rn(wu0, fv), __ldg(map + id01)));
      term = __fadd_rn(term, __fmul_rn(__fmul_rn(fu, wv0), __ldg(map + id10)));
      term = __fadd_rn(term, __fmul_rn(__fmul_rn(fu, fv), __ldg(map + id11)));
      acc = __fadd_rn(acc, term);
    }
  }
  if (active) out[pose] = acc;
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int pose_scoring(const void* angle, const void* trans,
                            const void* sim, const void* xy,
                            const void* valid_points, const void* valid_map,
                            void* out, int B, int P, int N, int H, int W,
                            float cell, int mask, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads), (unsigned)B);
  pose_scoring_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(angle), static_cast<const float*>(trans),
      static_cast<const float*>(sim), static_cast<const float*>(xy),
      static_cast<const uint8_t*>(valid_points),
      static_cast<const uint8_t*>(valid_map), static_cast<float*>(out), P, N,
      H, W, cell, mask);
  return (int)cudaGetLastError();
}
