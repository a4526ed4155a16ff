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
// uncommitted or unwaited aborts (emu_launch checks)
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
template <int N>
inline void cp_async(void* dst, const void* src) {
  if (reinterpret_cast<uintptr_t>(dst) % N || reinterpret_cast<uintptr_t>(src) % N) {
    fprintf(stderr, "cp.async: %d-byte copy not %d-byte aligned\n", N, N);
    abort();
  }
  emu_issued.push_back({dst, src, N});
}
inline void cp_async_commit() {
  emu_committed.push_back(std::move(emu_issued));
  emu_issued.clear();
}
template <int N>
inline void cp_async_wait() {
  while (emu_committed.size() > static_cast<size_t>(N)) {
    for (const EmuCopy& c : emu_committed.front()) memcpy(c.dst, c.src, c.n);
    emu_committed.erase(emu_committed.begin());
  }
}

}  // namespace ptx
