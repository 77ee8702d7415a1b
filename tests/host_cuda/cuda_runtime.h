// A host stand-in for the parts of the CUDA runtime that the sources of
// hector_torch/csrc/ use, so that the tests can compile them with g++ and
// run their kernels on the CPU: each thread
// of a block is a std::thread, the blocks of a grid run one cluster after
// another (a cluster's blocks together, one block where the launch names no
// cluster), __syncthreads is a std::barrier of the block, "bar.sync 1,
// count" a counting barrier of the block, the cluster barrier a
// std::barrier of the cluster's threads that a thread leaves when it
// exits (barrier.cluster waits for the threads that have not exited), mapa
// the same offset in the partner block's dynamic shared memory, and
// cp.async a copy made when the issuing thread waits for its group, its
// destination NaN from the issue until then (so a read before the wait, or
// a copy into a buffer that is still being read, shows).  A warp's
// __syncwarp is a std::barrier of its threads, and its shuffles and votes
// pass through a 32-entry buffer between two of them (every lane of the
// warp takes part, as the full masks say); atomics are the compiler's.  It
// checks indexing and ordering, not speed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

using std::isfinite;
using std::isnan;
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

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

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
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
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
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* nc, K, const cudaLaunchConfig_t*) {
  *nc = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T>
cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t bytes) {
  std::memcpy(dst, &symbol, bytes);
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }

struct HostCountBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int arrived = 0;
  long generation = 0;
};

// a warp: its barrier and the buffer its shuffles and votes pass through
struct HostWarp {
  std::unique_ptr<std::barrier<>> bar;
  float val[32];
  int pred[32];
};

// what the running thread's block and cluster share: the block's barrier,
// counting barrier and dynamic shared memory, the cluster's barrier and
// its blocks' dynamic shared memory; and its warp
inline thread_local HostWarp* host_warp = nullptr;
inline thread_local std::barrier<>* host_block_barrier = nullptr;
inline thread_local HostCountBarrier* host_count_barrier = nullptr;
inline thread_local float* host_block_smem = nullptr;
inline thread_local std::barrier<>* host_cluster_barrier = nullptr;
inline thread_local float* const* host_cluster_smem = nullptr;

inline float* host_smem() { return host_block_smem; }
inline size_t __cvta_generic_to_shared(const void* p) {
  return reinterpret_cast<size_t>(p);
}
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) { host_warp->bar->arrive_and_wait(); }
inline int host_lane() { return static_cast<int>(threadIdx.x & 31u); }
inline float __shfl_sync(unsigned, float v, int src) {
  host_warp->val[host_lane()] = v;
  __syncwarp();
  const float r = host_warp->val[src & 31];
  __syncwarp();
  return r;
}
inline float __shfl_xor_sync(unsigned mask, float v, int offset) {
  return __shfl_sync(mask, v, host_lane() ^ offset);
}
// every lane's predicate, after one barrier (and a second before the buffer
// is written again)
template <class F>
int host_vote(int pred, F combine) {
  host_warp->pred[host_lane()] = pred != 0;
  __syncwarp();
  int r = host_warp->pred[0];
  for (int i = 1; i < 32; ++i) r = combine(r, host_warp->pred[i]);
  __syncwarp();
  return r;
}
inline int __all_sync(unsigned, int pred) {
  return host_vote(pred, [](int a, int b) { return a & b; });
}
inline int __any_sync(unsigned, int pred) {
  return host_vote(pred, [](int a, int b) { return a | b; });
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline void host_cluster_sync() { host_cluster_barrier->arrive_and_wait(); }

// mapa: the same offset in block `rank`'s dynamic shared memory
inline float* host_map_shared(float* p, unsigned rank) {
  return host_cluster_smem[rank] + (p - host_block_smem);
}

// cp.async, commit_group, wait_group: each thread's copies since its last
// commit, and its committed groups, oldest first
struct HostCopy {
  float* dst;
  const float* src;
  int bytes;
};
inline thread_local std::vector<HostCopy> host_copies_open;
inline thread_local std::deque<std::vector<HostCopy>> host_copy_groups;

inline void host_cp_async(float* dst, const float* src, int bytes) {
  std::fill(dst, dst + bytes / sizeof(float), std::nanf(""));
  host_copies_open.push_back({dst, src, bytes});
}

inline void host_cp_async_commit() {
  host_copy_groups.push_back(std::move(host_copies_open));
  host_copies_open.clear();
}

// make the copies of all but the `pending` newest groups
inline void host_cp_async_wait(int pending) {
  while (static_cast<int>(host_copy_groups.size()) > pending) {
    for (const HostCopy& c : host_copy_groups.front()) std::memcpy(c.dst, c.src, c.bytes);
    host_copy_groups.pop_front();
  }
}

inline void host_bar_sync(int count) {
  HostCountBarrier& b = *host_count_barrier;
  std::unique_lock<std::mutex> lock(b.mu);
  const long mine = b.generation;
  if (++b.arrived == count) {
    b.arrived = 0;
    ++b.generation;
    b.cv.notify_all();
    return;
  }
  b.cv.wait(lock, [&] { return b.generation != mine; });
}

// Run `grid` blocks of `threads` threads, `cluster` blocks at a time.
template <class Kernel, class... Args>
void host_run(Kernel kernel, int grid, int threads, size_t smem, int cluster,
              Args... args) {
  for (int c0 = 0; c0 < grid; c0 += cluster) {
    struct Block {
      std::vector<float> smem;
      std::unique_ptr<std::barrier<>> bar;
      HostCountBarrier count;
      std::vector<HostWarp> warps;
    };
    std::vector<Block> blocks(cluster);
    std::vector<float*> smems(cluster);
    for (int r = 0; r < cluster; ++r) {
      // unwritten shared memory reads as NaN
      blocks[r].smem.assign(smem / sizeof(float) + 4, std::nanf(""));
      blocks[r].bar = std::make_unique<std::barrier<>>(threads);
      smems[r] = blocks[r].smem.data();
      blocks[r].warps.resize((threads + 31) / 32);
      for (int w = 0; w < (threads + 31) / 32; ++w)
        blocks[r].warps[w].bar = std::make_unique<std::barrier<>>(min(32, threads - 32 * w));
    }
    std::barrier<> cluster_bar(cluster * threads);
    std::vector<std::thread> pool;
    for (int r = 0; r < cluster; ++r)
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, r, t]() {
          threadIdx.x = t;
          blockIdx.x = c0 + r;
          blockDim.x = threads;
          gridDim.x = grid;
          host_warp = &blocks[r].warps[t / 32];
          host_block_barrier = blocks[r].bar.get();
          host_count_barrier = &blocks[r].count;
          host_block_smem = smems[r];
          host_cluster_barrier = &cluster_bar;
          host_cluster_smem = smems.data();
          kernel(args...);
          // a copy never waited for is never made
          host_copies_open.clear();
          host_copy_groups.clear();
          // an exited thread is waited for by no barrier
          host_warp->bar->arrive_and_drop();
          blocks[r].bar->arrive_and_drop();
          cluster_bar.arrive_and_drop();
        });
    for (auto& th : pool) th.join();
  }
}

// kernel<<<grid, threads, smem, stream>>>(args...)
template <class Kernel, class... Args>
void host_launch(Kernel kernel, int grid, int threads, size_t smem, cudaStream_t,
                 Args... args) {
  host_run(kernel, grid, threads, smem, 1, args...);
}

// cudaLaunchKernelEx with a 1-D grid and, optionally, a cluster dimension
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                               Act&&... args) {
  int cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = static_cast<int>(cfg->attrs[i].val.clusterDim.x);
  const int grid = static_cast<int>(cfg->gridDim.x);
  if (cluster < 1 || grid % cluster != 0) return cudaErrorInvalidValue;
  host_run(kernel, grid, static_cast<int>(cfg->blockDim.x), cfg->dynamicSmemBytes,
           cluster, static_cast<Exp>(args)...);
  return cudaSuccess;
}
