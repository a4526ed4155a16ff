// Device helpers shared by the two attention kernels (paged_attention.cu,
// flash_attention.cu): dtype conversion, warp reductions, the online-softmax
// update of a block's query rows by one key tile in shared memory, the
// final normalization, and the launch with a shared-memory opt-in.
//
// Both kernels keep the same block state in shared memory:
//   qs   [rows][dh]     query rows as f32
//   acc  [rows][dh]     un-normalized f32 accumulator
//   m_s, l_s [rows]     running max and denominator
//   ks, vs [<= 32][dh + 1]  the current key tile (padded rows: no bank
//                        conflicts when a lane reads its own key)
//   pbuf [warps][32]    one warp's probabilities for the tile
// Each kernel stages its own tile (a page-table walk with dequantization,
// or a dense K/V tile) and its own mask; the rest is here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Every query row of the block consumes one key tile of n_keys <= 32 keys:
// one warp per row, one key per lane for the scores, one head-dim channel
// per lane for P.V.  allow(r, key) says whether row r may attend the tile's
// key `key`; a masked score is neg_inf (finite, as in the reference), a lane
// past n_keys is -inf (no key at all).  The caller syncs the block before
// and after.
template <int kWarps, typename Allow>
__device__ __forceinline__ void consume_tile(
    const float* qs, float* acc, float* m_s, float* l_s, const float* ks,
    const float* vs, float* pbuf, int rows, int dh, int n_keys, float scale,
    float softcap, float neg_inf, Allow allow) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ldk = dh + 1;
  for (int r = warp; r < rows; r += kWarps) {
    float s = -INFINITY;
    if (lane < n_keys) {
      const float* qr = qs + r * dh;
      const float* kr = ks + lane * ldk;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = allow(r, lane) ? s : neg_inf;
    }
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, warp_max(s));
    const float p = lane < n_keys ? expf(s - m_new) : 0.f;
    const float alpha = expf(m_prev - m_new);
    const float psum = warp_sum(p);
    pbuf[warp * 32 + lane] = p;
    __syncwarp();
    if (lane == 0) {
      l_s[r] = l_s[r] * alpha + psum;
      m_s[r] = m_new;
    }
    for (int d = lane; d < dh; d += 32) {
      float a = acc[r * dh + d] * alpha;
      for (int kp = 0; kp < n_keys; ++kp)
        a = fmaf(pbuf[warp * 32 + kp], vs[kp * ldk + d], a);
      acc[r * dh + d] = a;
    }
    __syncwarp();
  }
}

// The output of element idx (row r) of the accumulator: acc / l, with the
// denominator floored at 1e-30.
template <typename T>
__device__ __forceinline__ void store_normalized(T* dst, const float* acc,
                                                 const float* l_s, int idx,
                                                 int r) {
  store(dst, acc[idx] / fmaxf(l_s[r], 1e-30f));
}

// Launch `kern` with `smem` bytes of dynamic shared memory.  Above the
// 48 KB default it opts in with cudaFuncSetAttribute once per size
// (`opted_in` is the caller's record for this instantiation), so a launch
// inside a CUDA-graph capture makes no attribute call.  Above the card's
// limit that call fails and its error is returned (and cleared, so the next
// launch does not report it): no launch is skipped silently.
template <typename... KArgs, typename... Args>
int launch_kernel(void (*kern)(KArgs...), size_t* opted_in, dim3 grid,
                  int threads, size_t smem, cudaStream_t st, Args... args) {
  if (smem > *opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    *opted_in = smem;
  }
  kern<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
