// Host emulation of csrc/ptx.cuh.  The warp-collective instructions
// exchange every lane's operands through the warp's buffer and compute
// each lane's result from them, with the fragment layouts of the PTX ISA.
// A tensor-core sum is modelled as: products exact, every addend (the
// accumulator too) truncated at the f32 ulp of the largest one, summed,
// and the result rounded toward zero.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {

inline float emu_tensor_sum(const double* t, int n) {
  double mx = 0;
  for (int i = 0; i < n; ++i) mx = std::fmax(mx, std::fabs(t[i]));
  if (mx == 0) return 0.f;
  int e;
  std::frexp(mx, &e);
  const double q = std::ldexp(1.0, e - 24);
  double acc = 0;
  for (int i = 0; i < n; ++i) acc += std::trunc(t[i] / q) * q;
  float f = static_cast<float>(acc);
  if (std::fabs(static_cast<double>(f)) > std::fabs(acc)) f = std::nextafter(f, 0.f);
  return f;
}

inline float emu_bf16(uint32_t reg, int half) {
  return __uint_as_float(((reg >> (16 * half)) & 0xffffu) << 16);
}

// D (16x8) += A (16x16 bf16, row) * B (16x8 bf16, col)
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  __syncwarp();
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double terms[17];
    terms[16] = d[e];
    for (int k = 0; k < 16; ++k)
      terms[k] = static_cast<double>(
                     emu_bf16(w.a[(r % 8) * 4 + (k % 8) / 2][(r >= 8) + 2 * (k >= 8)], k % 2)) *
                 emu_bf16(w.b[n * 4 + (k % 8) / 2][k >= 8], k % 2);
    out[e] = emu_tensor_sum(terms, 17);
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}

// D (16x8 s32) += A (16x32 s8, row) * B (32x8 s8, col); sums wrap modulo
// 2^32 as the tensor cores' do
inline void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  __syncwarp();
  auto byte = [](uint32_t reg, int k) {
    return static_cast<int32_t>(static_cast<int8_t>((reg >> (8 * (k % 4))) & 0xffu));
  };
  uint32_t out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    uint32_t acc = static_cast<uint32_t>(d[e]);
    for (int k = 0; k < 32; ++k)
      acc += static_cast<uint32_t>(
          byte(w.a[(r % 8) * 4 + (k % 16) / 4][(r >= 8) + 2 * (k >= 16)], k) *
          byte(w.b[n * 4 + (k % 16) / 4][k >= 16], k));
    out[e] = acc;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) d[e] = static_cast<int>(out[e]);
}

inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (reinterpret_cast<uintptr_t>(row) % 16) {
    fprintf(stderr, "ldmatrix: row address not 16-byte aligned\n");
    abort();
  }
  w.ptr[lane] = row;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    const auto* r0 = static_cast<const uint16_t*>(w.ptr[8 * i + 2 * t]);
    const auto* r1 = static_cast<const uint16_t*>(w.ptr[8 * i + 2 * t + 1]);
    r[i] = static_cast<uint32_t>(r0[g]) | (static_cast<uint32_t>(r1[g]) << 16);
  }
  __syncwarp();
}

// cp.async: a copy lands when a wait_group covers its committed group, so
// reading a stage too early sees stale bytes; a thread that ends with copies
// uncommitted or unwaited aborts (emu_launch checks; the queues are in
// cuda_runtime.h, which every kernel includes)
template <int N>
inline void cp_async(void* dst, const void* src) {
  if (reinterpret_cast<uintptr_t>(dst) % N || reinterpret_cast<uintptr_t>(src) % N) {
    fprintf(stderr, "cp.async: %d-byte copy not %d-byte aligned\n", N, N);
    abort();
  }
  emu_issued.push_back({dst, src, N});
}
// (copy false: the copy lands 16 zero bytes)
inline void cp_async_zfill16(void* dst, const void* src, bool copy) {
  cp_async<16>(dst, src);
  if (!copy) emu_issued.back().src = nullptr;
}
inline void cp_async_commit() {
  emu_committed.push_back(std::move(emu_issued));
  emu_issued.clear();
}
template <int N>
inline void cp_async_wait() {
  while (emu_committed.size() > static_cast<size_t>(N)) {
    for (const EmuCopy& c : emu_committed.front()) {
      if (c.src != nullptr)
        memcpy(c.dst, c.src, c.n);
      else
        memset(c.dst, 0, c.n);
    }
    emu_committed.erase(emu_committed.begin());
  }
}

// thread block clusters (emu_launch_clusters runs a cluster's blocks at once)
inline unsigned cluster_rank() { return emu_cluster_rank; }
inline void cluster_sync() { emu_cluster->bar->arrive_and_wait(); }
inline uint4 ld_cluster_v4(const void* p, unsigned rank) {
  const auto off = static_cast<const unsigned char*>(p) - emu_block->smem.data();
  uint4 v;
  memcpy(&v, emu_cluster->blocks[rank]->smem.data() + off, sizeof(v));
  return v;
}

}  // namespace ptx
