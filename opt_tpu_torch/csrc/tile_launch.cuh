// What the march kernels' host code shares: the blocks a card holds at
// once (warp_tile.cuh's chunk rule for K1, K3 and K15; K8's in
// vol_kernels.cu), and the three modes of the outer-step kernels K3
// (warp_kernels.cu) and K8 (vol_kernels.cu), one kernel template each.

#pragma once

#include <algorithm>
#include <cstddef>
#include <mutex>
#include <type_traits>
#include <vector>

#include <cuda_runtime.h>

namespace {

// K3's and K8's modes: J^T F, diag(J^T J) and the cost; the cost alone;
// LM's model cost 0.5 sum (F + J delta)^2 alone
enum LinearizeMode { kFull = 0, kCostOnly = 1, kModelCost = 2 };

// f(std::integral_constant<int, kMode>{}) for the runtime `mode`, so that
// f can name the mode's kernel; `error` for any other value
template <class F>
int with_mode(int mode, int error, F f) {
  switch (mode) {
    case kFull:
      return f(std::integral_constant<int, kFull>{});
    case kCostOnly:
      return f(std::integral_constant<int, kCostOnly>{});
    case kModelCost:
      return f(std::integral_constant<int, kModelCost>{});
  }
  return error;
}

// The blocks of `kernel` the current device holds at once at `threads`
// threads and `smem` bytes of dynamic shared memory a block (granted
// beforehand where it is over 48 KB): its occupancy with the kernel's
// registers, times the SMs; cached per kernel, device, threads and smem.
// Minus the CUDA error where a query fails.
template <class Kernel>
int tile_capacity(Kernel kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int capacity;
  };
  static std::mutex lock;
  static std::vector<Entry> cache;
  const void* key = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Entry& e : cache)
      if (e.kernel == key && e.dev == dev && e.threads == threads &&
          e.smem == smem)
        return e.capacity;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return -(int)err;
  const int capacity = std::max(1, sms * per_sm);
  std::lock_guard<std::mutex> hold(lock);
  cache.push_back(Entry{key, dev, threads, smem, capacity});
  return capacity;
}

}  // namespace
