// A host stand-in for the parts of the CUDA runtime that
// hector_torch/csrc/chol.cu uses, so that tests/test_torch_chol_host.py can
// compile that source with g++ and run its kernels on the CPU: each thread
// of a block is a std::thread, the blocks of a grid run one after another,
// __syncthreads is a std::barrier, "bar.sync 1, count" a counting barrier,
// cp.async a plain copy.  It checks indexing and ordering, not speed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;
using std::signbit;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct HostDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim threadIdx, blockIdx, blockDim, gridDim;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
  size_t sharedSizeBytes;
};
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = cudaFuncAttributes{0, 0, 0};
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* nb, K, int, size_t) {
  *nb = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }

// the block being run: its barrier, its counting barrier, its dynamic
// shared memory
inline std::barrier<>* host_block_barrier = nullptr;
inline std::vector<float> host_dynamic_smem;
inline float* host_smem() { return host_dynamic_smem.data(); }
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

struct HostCountBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int arrived = 0;
  long generation = 0;
};
inline HostCountBarrier host_count_barrier;
inline void host_bar_sync(int count) {
  std::unique_lock<std::mutex> lock(host_count_barrier.mu);
  const long mine = host_count_barrier.generation;
  if (++host_count_barrier.arrived == count) {
    host_count_barrier.arrived = 0;
    ++host_count_barrier.generation;
    host_count_barrier.cv.notify_all();
    return;
  }
  host_count_barrier.cv.wait(lock, [&] { return host_count_barrier.generation != mine; });
}

// kernel<<<grid, threads, smem, stream>>>(args...)
template <class Kernel, class... Args>
void host_launch(Kernel kernel, int grid, int threads, size_t smem, cudaStream_t,
                 Args... args) {
  // unwritten shared memory reads as NaN
  host_dynamic_smem.assign(smem / sizeof(float) + 4, std::nanf(""));
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(threads);
    host_block_barrier = &bar;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t]() {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        gridDim.x = grid;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}
