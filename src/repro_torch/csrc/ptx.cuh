// Inline PTX used by the attention kernels (attention_common.cuh): the
// warp-level bf16 tensor-core product (mma.sync), the transposing
// shared-memory fragment load (ldmatrix) and asynchronous global-to-shared
// copies (cp.async).  Every operand is an ordinary pointer or register
// here; the callers own the fragment layouts (see attention_common.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i (16 bytes a row, 16-byte aligned); lane l receives in r[i]
// matrix i's elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// asynchronous copy of N bytes (4, 8 or 16; both addresses N-aligned)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ptx
