// Host emulation of the CUDA runtime as the kernels use it: a block's
// threads are OS threads, __syncthreads and __syncwarp are barriers, a
// shuffle goes through the warp's exchange buffer, and a launch runs the
// grid's blocks one after the other, in the order that the environment
// variable CUDA_EMU_BLOCK_ORDER names: "forward" (default), "reverse" or
// "shuffle:<seed>".
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr int kEmuSharedLimit = 232448;  // an H100 block's shared memory
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > kEmuSharedLimit ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a small card: the blocks of an emulated grid run one after the other
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 4;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
// device-scope fence and an L2 load: the blocks of a grid run one after
// the other here, so both are plain memory accesses
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
template <class T>
inline T __ldcg(const T* p) { return *p; }
inline float __int2float_rn(int v) { return static_cast<float>(v); }  // nearest even
inline int __float2int_rn(float v) { return static_cast<int>(std::nearbyint(v)); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  uint32_t a[32][4], b[32][2];
  float f[32];
  const void* ptr[32];
};
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<EmuWarp> warps;
  std::vector<unsigned char> smem;
  EmuBlock(int threads, size_t bytes) : warps((threads + 31) / 32), smem(bytes + 16, 0xff) {
    bar = std::make_unique<std::barrier<>>(threads);
    for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
  }
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline thread_local EmuBlock* emu_block;
inline unsigned char* emu_shared() { return emu_block->smem.data(); }
inline EmuWarp& emu_warp() { return emu_block->warps[threadIdx.x / 32]; }
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp().bar->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src_lane) {
  EmuWarp& w = emu_warp();
  w.f[threadIdx.x & 31] = v;
  __syncwarp();
  const float r = w.f[src_lane & 31];
  __syncwarp();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  w.f[lane] = v;
  __syncwarp();
  const float r = w.f[lane ^ lane_mask];
  __syncwarp();
  return r;
}

// each thread's cp.async copies (include/ptx.cuh): issued, and committed
// in groups
namespace ptx {
struct EmuCopy {
  void* dst;
  const void* src;
  int n;
};
inline thread_local std::vector<EmuCopy> emu_issued;
inline thread_local std::vector<std::vector<EmuCopy>> emu_committed;
inline bool emu_copies_in_flight() {
  return !emu_issued.empty() || !emu_committed.empty();
}
}  // namespace ptx

// the blocks of one thread block cluster: they run at once, share a
// barrier, and map each other's shared memory (by rank, x fastest)
struct EmuCluster {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<EmuBlock>> blocks;
};
inline thread_local EmuCluster* emu_cluster;
inline thread_local unsigned emu_cluster_rank;

// stands in for kern<<<grid, threads, smem, stream>>>(args...) and for a
// launch of clusters of `cluster` blocks; shared memory starts as 0xff
// bytes, so that reads of unwritten cells show.  Clusters run one after
// the other, in the order CUDA_EMU_BLOCK_ORDER names.
template <class K, class... A>
void emu_launch_clusters(K kern, dim3 grid, dim3 cluster, int threads, size_t smem,
                         A... args) {
  if (smem > static_cast<size_t>(kEmuSharedLimit)) {
    fprintf(stderr, "emulated launch: %zu bytes of shared memory\n", smem);
    abort();
  }
  if (grid.x % cluster.x || grid.y % cluster.y || grid.z % cluster.z ||
      cluster.x * cluster.y * cluster.z > 8) {
    fprintf(stderr, "emulated launch: clusters (%u, %u, %u) do not tile the grid "
            "(%u, %u, %u) or hold more than 8 blocks\n", cluster.x, cluster.y,
            cluster.z, grid.x, grid.y, grid.z);
    abort();
  }
  gridDim = grid;
  blockDim = dim3(threads);
  std::vector<dim3> order;
  for (unsigned z = 0; z < grid.z; z += cluster.z)
    for (unsigned y = 0; y < grid.y; y += cluster.y)
      for (unsigned x = 0; x < grid.x; x += cluster.x) order.emplace_back(x, y, z);
  const char* how = getenv("CUDA_EMU_BLOCK_ORDER");
  const std::string mode = how ? how : "forward";
  if (mode == "reverse") {
    std::reverse(order.begin(), order.end());
  } else if (mode.rfind("shuffle:", 0) == 0) {
    std::mt19937 rng(static_cast<unsigned>(std::stoul(mode.substr(8))));
    std::shuffle(order.begin(), order.end(), rng);
  } else if (mode != "forward") {
    fprintf(stderr, "CUDA_EMU_BLOCK_ORDER=%s: forward, reverse or shuffle:<seed>\n",
            mode.c_str());
    abort();
  }
  const unsigned n = cluster.x * cluster.y * cluster.z;
  for (const dim3 origin : order) {
    EmuCluster cl;
    cl.bar = std::make_unique<std::barrier<>>(static_cast<std::ptrdiff_t>(n) * threads);
    for (unsigned r = 0; r < n; ++r) cl.blocks.push_back(std::make_unique<EmuBlock>(threads, smem));
    std::vector<std::thread> ts;
    for (unsigned r = 0; r < n; ++r) {
      const dim3 b(origin.x + r % cluster.x, origin.y + r / cluster.x % cluster.y,
                   origin.z + r / (cluster.x * cluster.y));
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, r, b, t] {
          threadIdx = dim3(t);
          blockIdx = b;
          emu_block = cl.blocks[r].get();
          emu_cluster = &cl;
          emu_cluster_rank = r;
          kern(args...);
          if (ptx::emu_copies_in_flight()) {
            fprintf(stderr, "emulated block (%u, %u, %u) thread %d ended with "
                    "cp.async copies in flight\n", b.x, b.y, b.z, t);
            abort();
          }
          emu_warp().bar->arrive_and_drop();
          emu_block->bar->arrive_and_drop();
          cl.bar->arrive_and_drop();
        });
    }
    for (auto& th : ts) th.join();
  }
}

template <class K, class... A>
void emu_launch(K kern, dim3 grid, int threads, size_t smem, A... args) {
  emu_launch_clusters(kern, grid, dim3(1, 1, 1), threads, smem, args...);
}

// cudaLaunchKernelEx with a cluster dimension attribute
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*kern)(E...), A&&... args) {
  dim3 cluster(1, 1, 1);
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = dim3(c->attrs[i].val.clusterDim.x, c->attrs[i].val.clusterDim.y,
                     c->attrs[i].val.clusterDim.z);
  emu_launch_clusters(kern, c->gridDim, cluster, static_cast<int>(c->blockDim.x),
                      c->dynamicSmemBytes, static_cast<E>(args)...);
  return cudaSuccess;
}
