// B6: row gather from a small table, out[i, :] = table[ids[i], :].
//
// Replaces tools/bench_gather.py:dyngather_kernel (driven by
// pallas_dyngather): a take_along_axis along axis 0 of a table held in
// VMEM, in blocks of 2048 ids. The tool's table is [8, 128] f32 (4 KB);
// here it is staged once per block in shared memory, and each output row is
// written as float4s (16 bytes a lane, a warp writing 512 contiguous bytes).
// Ids outside [0, rows) are clamped, as an XLA gather clamps them (the
// plain version clamps alike); the tool's ids are in range.
//
// The tool's grid covers N // 2048 blocks and leaves the last N mod 2048
// rows unwritten (ROADMAP C13); this kernel covers all N.
//
// What bounds it on an H100: bytes. At the tool's N = 1,152,000 the output
// is 589.8 MB and the ids 4.6 MB: ~0.177 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

LaunchLog launches;

constexpr int kThreads = 256;
constexpr int kMaxTableFloats = 2048;  // 8 KB of static shared memory

__global__ void table_gather_kernel(
    const float4* __restrict__ table,  // [rows, D] f32, as D / 4 float4s
    const int* __restrict__ ids,       // [N]
    float4* __restrict__ out,          // [N, D] f32, as D / 4 float4s
    long long N, int rows, int quads) {
  __shared__ float4 s_table[kMaxTableFloats / 4];
  for (int k = threadIdx.x; k < rows * quads; k += kThreads)
    s_table[k] = table[k];
  __syncthreads();
  const long long total = N * quads;
  for (long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
       item < total; item += (long long)gridDim.x * kThreads) {
    const long long i = item / quads;
    const int k = (int)(item - i * quads);
    const int row = min(max(__ldg(ids + i), 0), rows - 1);
    out[item] = s_table[row * quads + k];
  }
}

}  // namespace

// table: [rows, D] f32 with D a multiple of 4 and rows * D <= 2048; ids:
// [N] int32; out: [N, D] f32. Returns a cudaError_t (0 on success).
extern "C" int table_gather(const void* table, const void* ids, void* out,
                            long long N, int rows, int D, int num_sms,
                            void* stream) {
  launches.clear();
  if (N <= 0) return 0;
  if (D % 4 || rows <= 0 || (long long)rows * D > kMaxTableFloats)
    return (int)cudaErrorInvalidValue;
  const int quads = D / 4;
  const long long items = N * quads;
  // A grid-stride loop over enough blocks to fill the card: each block
  // stages the table once.
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  launches.add(table_gather_kernel, "table_gather_kernel", kThreads, 0);
  table_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(ids),
      static_cast<float4*>(out), N, rows, quads);
  return (int)cudaGetLastError();
}

// The launches of the last call (launch_log.cuh). Returns their count, or
// minus a cudaError_t.
extern "C" int table_gather_occupancy(KernelOccupancy* out, int capacity) {
  return launches.report(out, capacity);
}
