// The kernel launches of an entry point's last call, and their residency.
//
// A launcher notes each launch (kernel, block size, dynamic shared memory)
// in its source file's LaunchLog; the file's <entry>_occupancy export
// reports, for each launch of the last call, the kernel's registers,
// static shared memory and local (spilled) bytes from
// cudaFuncGetAttributes, and the blocks per SM that the card keeps
// resident at that launch's own block size and dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

// Mirrored by ops/kernels.py:_Occupancy.
struct KernelOccupancy {
  const char* name;
  int threads, dynamic_smem, registers, static_smem, local_bytes,
      blocks_per_sm;
};

class LaunchLog {
 public:
  void clear() { count_ = 0; }

  template <typename Kernel>
  void add(Kernel kernel, const char* name, int threads, int dynamic_smem) {
    if (count_ < kMax)
      entries_[count_++] = {reinterpret_cast<const void*>(kernel), name,
                            threads, dynamic_smem};
  }

  // Fills out[0, min(count, capacity)); returns the count of launches, or
  // minus a cudaError_t.
  int report(KernelOccupancy* out, int capacity) const {
    for (int i = 0; i < count_ && i < capacity; ++i) {
      const Entry& e = entries_[i];
      cudaFuncAttributes attr;
      cudaError_t code = cudaFuncGetAttributes(&attr, e.kernel);
      int blocks = 0;
      if (code == cudaSuccess)
        code = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, e.kernel, e.threads, (size_t)e.dynamic_smem);
      if (code != cudaSuccess) return -(int)code;
      out[i] = {e.name, e.threads, e.dynamic_smem, attr.numRegs,
                (int)attr.sharedSizeBytes, (int)attr.localSizeBytes, blocks};
    }
    return count_;
  }

 private:
  struct Entry {
    const void* kernel;
    const char* name;
    int threads, dynamic_smem;
  };
  static constexpr int kMax = 8;
  Entry entries_[kMax];
  int count_ = 0;
};
