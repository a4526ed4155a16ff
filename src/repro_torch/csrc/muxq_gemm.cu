// Fused MUXQ int8 GEMM with per-K-block power-of-two scales (paper Eq. 7):
//
//   Y = (sum_kb block_scale[kb] * X[:, kb] @ W[kb, :]) * sx * sw
//
// Replaces: src/repro/kernels/muxq_gemm.py `_kernel` / `muxq_gemm` (Pallas).
//
// Bound on an H100: at the decode batch of the serving path (M of a few
// rows) the kernel must read every weight byte once for ~2*M operations
// per byte, so it is bound by the K*N weight bytes; only from M in the
// hundreds does the int8 tensor-core rate (1,979 TOP/s) take over.
// Design: int8 tensor-core MMA (mma.sync m16n8k32, s8 x s8 -> s32) on
// 32x64 output tiles, four warps each owning a 16x32 sub-tile.  The K loop
// walks 64-wide tiles, which divide the artifact's K-block width bk, so a
// K-block's int32 partial sum is complete at a tile boundary; it is then
// multiplied by the block's 2^e (exact: |partial| <= 127*127*bk and the
// scaled total stays inside int32) and added to the accumulator.  The
// dequant (acc * sx[m] * sw[n], in that order, as the reference does)
// runs in the epilogue.  The weight tile is staged transposed ([n][k]) in
// shared memory because the MMA's B operand wants four consecutive k per
// register; rows are padded to 80 bytes so the fragment loads are free of
// bank conflicts.  Ragged M and N are masked in the loads and the stores.
// A simple, right kernel first: no cp.async pipeline, no split-K, no
// wgmma — the decode shapes launch few blocks (N/64 of them).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 64;
constexpr int LDS = BK + 16;  // bytes per shared-memory row (padded)
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) muxq_gemm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int* __restrict__ block_scale, const float* __restrict__ sx,
    const float* __restrict__ sw, float* __restrict__ out, int M, int N,
    int K, int bk) {
  __shared__ __align__(16) int8_t xs[BM * LDS];  // [m][k]
  __shared__ __align__(16) int8_t wt[BN * LDS];  // [n][k] (transposed)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;

  int acc[4][4], part[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // X tile: 32 rows x 64 bytes, one 16-byte chunk per thread
      const int r = tid >> 2, c = (tid & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const int4*>(x + static_cast<size_t>(m0 + r) * K +
                                           k0 + c);
      *reinterpret_cast<int4*>(xs + r * LDS + c) = v;
    }
    // W tile: 64 k-rows x 64 n-cols, two 16-byte chunks per thread
    for (int i = tid; i < BK * BN / 16; i += kThreads) {
      const int kr = i >> 2, c = (i & 3) * 16;
      const int8_t* src = w + static_cast<size_t>(k0 + kr) * N + n0 + c;
      union {
        int4 v;
        int8_t b[16];
      } u;
      if (n0 + c + 16 <= N &&
          (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        u.v = *reinterpret_cast<const int4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) u.b[j] = (n0 + c + j < N) ? src[j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) wt[(c + j) * LDS + kr] = u.b[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int8_t* xa = xs + (wm + g) * LDS + kk + t * 4;
      const int a[4] = {*reinterpret_cast<const int*>(xa),
                        *reinterpret_cast<const int*>(xa + 8 * LDS),
                        *reinterpret_cast<const int*>(xa + 16),
                        *reinterpret_cast<const int*>(xa + 8 * LDS + 16)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* wb = wt + (wn + j * 8 + g) * LDS + kk + t * 4;
        const int b[2] = {*reinterpret_cast<const int*>(wb),
                          *reinterpret_cast<const int*>(wb + 16)};
        mma_s8(part[j], a, b);
      }
    }
    __syncthreads();
    if ((k0 + BK) % bk == 0) {  // a K-block is complete: scale it in
      const int s = block_scale[k0 / bk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i] += part[j][i] * s;
          part[j][i] = 0;
        }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm + g + (i >= 2 ? 8 : 0);
      const int col = n0 + wn + j * 8 + t * 2 + (i & 1);
      if (row < M && col < N)
        out[static_cast<size_t>(row) * N + col] = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[j][i]), sx[row]), sw[col]);
    }
}

}  // namespace

// x int8 [M, K] (16-byte aligned rows: K % 64 == 0), w int8 [K, N],
// block_scale int32 [K / bk], sx f32 [M], sw f32 [N] -> out f32 [M, N].
// bk must be a multiple of 64.
extern "C" int muxq_gemm_launch(const void* x, const void* w,
                                const void* block_scale, const void* sx,
                                const void* sw, void* out, int M, int N, int K,
                                int bk, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  muxq_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(block_scale), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<float*>(out), M, N, K, bk);
  return static_cast<int>(cudaGetLastError());
}
