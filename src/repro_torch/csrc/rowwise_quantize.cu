// Row-wise (per-token) abs-max integer quantization, optionally fused with
// the MUXQ channel gather and 2^-e outlier shift.
//
// Replaces: src/repro/kernels/quantize.py `_kernel` / `rowwise_quantize`
// (Pallas), and on the fused path also the jnp `_permute_pad_shift`
// (src/repro/kernels/ops.py) that runs just before it.
//
// Bound on an H100: bytes.  Per row the kernel reads K_in activations and
// writes K_out int8 codes plus one f32 scale; the arithmetic is a handful
// of operations per element, far below the card's ~295 operations/byte
// balance point.  Design: one block per row, so the abs-max is a block
// reduction (warp shuffles, then one shared-memory step across warps) and
// no second kernel is needed.  The body value x[gather[k]] * in_scale[k]
// is recomputed in the second pass rather than staged in shared memory:
// the row is in L1/L2 after the first pass, and this keeps the kernel
// free of a width limit.
//
// Numerics match the reference exactly: the body is cast back to the
// input dtype before the abs-max (bf16 inputs give the codes the jnp
// version gives), amax is floored at 1e-9, scale = amax / qmax and
// q = clip(rint(x / scale)) with a true IEEE division and round half to
// even.  Built without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// value as stored in T (the reference's `.astype(x.dtype)`), back in f32
__device__ __forceinline__ float round_trip(float v, const float*) { return v; }
__device__ __forceinline__ float round_trip(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float body(const T* __restrict__ xr,
                                      const int* __restrict__ gather,
                                      const float* __restrict__ in_scale,
                                      int k) {
  if (gather == nullptr) return to_float(xr[k]);
  return round_trip(__fmul_rn(to_float(xr[gather[k]]), in_scale[k]), xr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rowwise_quantize_kernel(
    const T* __restrict__ x, const int* __restrict__ gather,
    const float* __restrict__ in_scale, int8_t* __restrict__ q,
    float* __restrict__ s, int k_in, int k_out, int qmax) {
  __shared__ float warp_max[kThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * k_in;
  int8_t* qr = q + static_cast<size_t>(row) * k_out;

  float amax = 0.f;
  for (int k = threadIdx.x; k < k_out; k += kThreads)
    amax = fmaxf(amax, fabsf(body(xr, gather, in_scale, k)));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float qm = static_cast<float>(qmax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-9f), qm);
  for (int k = threadIdx.x; k < k_out; k += kThreads) {
    float v = rintf(__fdiv_rn(body(xr, gather, in_scale, k), scale));
    v = fminf(fmaxf(v, -qm), qm);
    qr[k] = static_cast<int8_t>(__float2int_rn(v));
  }
  if (threadIdx.x == 0) s[row] = scale;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  gather/in_scale may both be null
// (plain per-row quantization of x [m, k_in], k_out == k_in).
extern "C" int rowwise_quantize_launch(const void* x, const void* gather,
                                       const void* in_scale, void* q, void* s,
                                       int m, int k_in, int k_out, int qmax,
                                       int dtype, void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gather);
  const float* sc = static_cast<const float*>(in_scale);
  if (dtype == 0) {
    rowwise_quantize_kernel<float><<<m, kThreads, 0, st>>>(
        static_cast<const float*>(x), g, sc, static_cast<int8_t*>(q),
        static_cast<float*>(s), k_in, k_out, qmax);
  } else if (dtype == 1) {
    rowwise_quantize_kernel<__nv_bfloat16><<<m, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), g, sc, static_cast<int8_t*>(q),
        static_cast<float*>(s), k_in, k_out, qmax);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
