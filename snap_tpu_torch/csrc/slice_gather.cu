// B5: the unweighted 2x2 tap sum of a flat, row-padded image stack.
//
// Replaces tools/bench_gather.py:pallas_slice_kernel (built by
// make_pallas_slice, driven by pallas_slice): per point i with flat row id
// rid = r0 (W + 1) + c0 of the stack [R (W + 1), C] (bf16),
//   out[i] = s[rid] + s[rid + 1] + s[rid + W + 1] + s[rid + W + 2].
// The TPU kernel holds the whole stack (18.0 MB at the tool's shape, R =
// 920 rows of W + 1 = 61 columns x C = 160) in VMEM and walks the points of
// a 4096-point tile in a serial loop. On Hopper the stack cannot fit the
// 227 KB of shared memory a block may use; "resident" here means resident
// in the 50 MB L2, which holds it whole after the first touches.
//
// Numbers: the kernel converts the four taps to f32, adds them in the order
// above and rounds once to bf16 (round to nearest even), as the plain
// version does (ops/gathers.py:slice_gather_plain): the two agree to the
// bit. The TPU kernel adds in bf16, as (top + bot).sum(0), rounding each of
// its three sums, so against it the kernel differs by up to four bf16
// roundings (2^-8 each) of the taps' magnitudes.
//
// The tool's grid covers N // 4096 tiles and leaves the last N mod 4096
// rows unwritten (ROADMAP C13); this kernel covers all N.
//
// Design: one thread per (point, 16-byte chunk of channels): 8 bf16
// channels per 16-byte load of each tap, so the threads of a warp read
// 1.6 rows of 320 B each, coalesced, and write one 16-byte chunk each.
//
// What bounds it on an H100: bytes. At the tool's N = 1,152,000 points the
// output is 368.6 MB and the row ids 4.6 MB, the stack 18.0 MB read once
// from device memory: ~0.117 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

constexpr int kThreads = 256;

__device__ inline void add_chunk(float acc[8], const uint4& raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc[2 * k] = __fadd_rn(acc[2 * k], f.x);
    acc[2 * k + 1] = __fadd_rn(acc[2 * k + 1], f.y);
  }
}

__global__ void slice_gather_kernel(
    const uint4* __restrict__ stack,  // [rows, C] bf16, as C / 8 chunks
    const int* __restrict__ rid,      // [N]
    uint4* __restrict__ out,          // [N, C] bf16, as C / 8 chunks
    long long N, int chunks, int W, int rows) {
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= N * chunks) return;
  const long long i = item / chunks;
  const int k = (int)(item - i * chunks);
  // Clamp so that all four taps lie inside the stack (the plain version
  // clamps alike); the tool's row ids are in range.
  const int r = min(max(__ldg(rid + i), 0), rows - W - 3);
  const long long taps[4] = {r, r + 1, r + W + 1, r + W + 2};
  float acc[8];
  const uint4 first = __ldg(stack + taps[0] * chunks + k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&first);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    acc[2 * j] = f.x;
    acc[2 * j + 1] = f.y;
  }
#pragma unroll
  for (int t = 1; t < 4; ++t)
    add_chunk(acc, __ldg(stack + taps[t] * chunks + k));
  uint4 packed;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  out[i * chunks + k] = packed;
}

}  // namespace

// stack: [rows, C] bf16 with C a multiple of 8 and 16-byte aligned rows;
// rid: [N] int32; out: [N, C] bf16. Returns a cudaError_t (0 on success).
extern "C" int slice_gather(const void* stack, const void* rid, void* out,
                            long long N, int C, int W, int rows,
                            void* stream) {
  launches.clear();
  if (N <= 0) return 0;
  const int chunks = C / 8;
  const long long items = N * chunks;
  const unsigned blocks = (unsigned)((items + kThreads - 1) / kThreads);
  launches.add(slice_gather_kernel, "slice_gather_kernel", kThreads, 0);
  slice_gather_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(stack), static_cast<const int*>(rid),
      static_cast<uint4*>(out), N, chunks, W, rows);
  return (int)cudaGetLastError();
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int slice_gather_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
