// Host emulation of the CUDA runtime as the attention kernels use it: a
// block's threads are OS threads, __syncthreads and __syncwarp are
// barriers, a shuffle goes through the warp's exchange buffer, and a
// launch runs the grid's blocks one after the other.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
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

namespace ptx {
inline bool emu_copies_in_flight();  // include/ptx.cuh
}

// stands in for kern<<<grid, threads, smem, stream>>>(args...); shared
// memory starts as 0xff bytes, so that reads of unwritten cells show
template <class K, class... A>
void emu_launch(K kern, dim3 grid, int threads, size_t smem, A... args) {
  if (smem > static_cast<size_t>(kEmuSharedLimit)) {
    fprintf(stderr, "emulated launch: %zu bytes of shared memory\n", smem);
    abort();
  }
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuBlock blk(threads, smem);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            emu_block = &blk;
            kern(args...);
            if (ptx::emu_copies_in_flight()) {
              fprintf(stderr, "emulated block (%u, %u, %u) thread %d ended with "
                      "cp.async copies in flight\n", x, y, z, t);
              abort();
            }
            emu_warp().bar->arrive_and_drop();
            blk.bar->arrive_and_drop();
          });
        for (auto& th : ts) th.join();
      }
}
