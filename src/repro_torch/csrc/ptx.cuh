// Inline PTX used by the kernels: the warp-level bf16 and int8 tensor-core
// products (mma.sync), the transposing shared-memory fragment load
// (ldmatrix), asynchronous global-to-shared copies (cp.async) and the
// thread block cluster's rank, barrier and remote shared-memory reads.
// Every operand is an ordinary pointer or register here; the callers own
// the fragment layouts (see attention_common.cuh and muxq_gemm.cu).
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

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32 accumulation (wrapping).
// Lane l (g = l / 4, t = l % 4) holds A rows g (a0, a2) and g + 8 (a1, a3)
// at k 4t..4t+3 (a0, a1) and 16+4t.. (a2, a3); B column g at k 4t.. (b0)
// and 16+4t.. (b1); D rows g (d0, d1) and g + 8 (d2, d3), columns 2t, 2t+1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
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

// 16 bytes as cp_async<16>, or (copy false) 16 zero bytes and no read
__device__ __forceinline__ void cp_async_zfill16(void* dst, const void* src, bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(copy ? 16 : 0));
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// thread block clusters: this block's rank in its cluster, a barrier of
// every thread of the cluster (release/acquire: shared-memory writes made
// before it are seen by the cluster's blocks after it), and a read of
// another block's shared memory
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 16 bytes at p (16-byte aligned) in the shared memory of block `rank`
// of the cluster (p: this block's address of the same variable)
__device__ __forceinline__ uint4 ld_cluster_v4(const void* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

}  // namespace ptx
