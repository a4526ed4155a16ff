// Row-wise (per-token) abs-max integer quantization, optionally fused with
// the MUXQ channel gather and 2^-e outlier shift.
//
// Replaces: src/repro/kernels/quantize.py `_kernel` / `rowwise_quantize`
// (Pallas), and on the fused path also the jnp `_permute_pad_shift`
// (src/repro/kernels/ops.py) that runs just before it.
//
// Bound on an H100: bytes, and they are few.  Per row the kernel reads
// K_in activations and K_out gather indices and in-scales and writes K_out
// codes plus one scale: 12 KB for a decode batch of 4 rows at K 768, 9 ns
// at 3.35 TB/s.  What a call costs is latency: the launch, then the chain
// gather index -> x[index] -> row max -> codes.
// Design: a latency kernel.  One block a row; the row's body values go in
// chunks of kChunk = 4 consecutive values, one chunk a thread up to 512
// threads and then up to kHeld = 4 chunks a thread (chunks tid, tid + 512,
// ...), so the decode widths (K_pad 1536 to 5632) take 384 to 512 threads
// and at most 11 values each.  Every load of a row is issued before any is
// used: the x row is copied whole into shared memory (16-byte cp.async)
// while each thread loads its chunks' gather indices and in-scales
// (16-byte loads), so the row costs one round trip to memory, not the two
// of the chain gather index -> x[index]; the gathers then read shared
// memory.  The body values stay in registers across the abs-max (warp
// shuffles, then one shared-memory step across warps) and the quantize;
// a chunk's codes leave as one 4-byte store, 128 contiguous bytes a warp.
// Measured on the H100 (tools/gemm_probe.py variants): chunks of 4 beat
// chunks of 8 and of 16 held one a thread (16 values with 16-byte code
// stores took 8.8 us against 7.2-7.5 at [4, 768]: a thread's serial work,
// not its stores, sets the time).  A row wider than 512 x 16 values
// gathers its remaining chunks twice, in a loop.  Rows that cannot be
// staged (over kStageBytes, not 16-byte aligned, a width that is not a
// multiple of kChunk) and the unfused path take scalar loads and stores.
//
// Numerics match the reference exactly: the body is cast back to the
// input dtype before the abs-max (bf16 inputs give the codes the jnp
// version gives), amax is floored at 1e-9, scale = amax / qmax and
// q = clip(rint(x / scale)) with a true IEEE division and round half to
// even.  The abs-max is exact in any order.  Built without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "ptx.cuh"

namespace {

constexpr int kChunk = 4;         // consecutive body values a chunk (one 16-byte load)
constexpr int kHeld = 4;          // chunks a thread holds in registers
constexpr int kMaxThreads = 512;
constexpr int kStageBytes = 96 << 10;   // the widest x row staged in shared memory

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// value as stored in T (the reference's `.astype(x.dtype)`), back in f32
__device__ __forceinline__ float round_trip(float v, const float*) { return v; }
__device__ __forceinline__ float round_trip(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the gather indices and in-scales of body values k .. k + kChunk - 1
// (past k_out: index 0, scale 0)
template <bool kStaged>
__device__ __forceinline__ void load_map(const int* __restrict__ gather,
                                         const float* __restrict__ in_scale, int k,
                                         int k_out, int (&idx)[kChunk],
                                         float (&sc)[kChunk]) {
  if (kStaged) {
    const int4 gi = *reinterpret_cast<const int4*>(gather + k);
    const float4 si = *reinterpret_cast<const float4*>(in_scale + k);
    idx[0] = gi.x, idx[1] = gi.y, idx[2] = gi.z, idx[3] = gi.w;
    sc[0] = si.x, sc[1] = si.y, sc[2] = si.z, sc[3] = si.w;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      idx[e] = k + e < k_out ? gather[k + e] : 0;
      sc[e] = k + e < k_out ? in_scale[k + e] : 0.f;
    }
  }
}

// the body values k .. k + kChunk - 1 of a row (0 past k_out) from its x row (in
// shared memory when staged); gather == nullptr: x itself, unfused
template <typename T, bool kStaged>
__device__ __forceinline__ void body(const T* __restrict__ xr, const int* __restrict__ gather,
                                     const float* __restrict__ in_scale, int k, int k_out,
                                     float (&v)[kChunk]) {
  if (gather == nullptr) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = k + e < k_out ? to_float(xr[k + e]) : 0.f;
    return;
  }
  int idx[kChunk];
  float sc[kChunk];
  load_map<kStaged>(gather, in_scale, k, k_out, idx, sc);
#pragma unroll
  for (int e = 0; e < kChunk; ++e)
    v[e] = k + e < k_out ? round_trip(__fmul_rn(to_float(xr[idx[e]]), sc[e]), xr) : 0.f;
}

template <bool kStaged>
__device__ __forceinline__ void store_chunk(int8_t* __restrict__ qr, int k, int k_out,
                                            const float (&v)[kChunk], float scale,
                                            float qm) {
  int code[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    const float r = rintf(__fdiv_rn(v[e], scale));
    code[e] = __float2int_rn(fminf(fmaxf(r, -qm), qm));
  }
  if (kStaged) {  // one 4-byte store of the chunk's codes
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) word |= static_cast<unsigned>(code[e] & 0xff) << (8 * e);
    *reinterpret_cast<unsigned*>(qr + k) = word;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (k + e < k_out) qr[k + e] = static_cast<int8_t>(code[e]);
  }
}

// kStaged (the serving path): the fused body with the x row staged in
// shared memory, 16-byte loads of the gather indices and in-scales and one
// store of a chunk's codes; otherwise (unfused, a row over kStageBytes, or
// widths and addresses that do not align) scalar loads and stores
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) rowwise_quantize_kernel(
    const T* __restrict__ x, const int* __restrict__ gather,
    const float* __restrict__ in_scale, int8_t* __restrict__ q,
    float* __restrict__ s, int k_in, int k_out, int qmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* warp_max = reinterpret_cast<float*>(smem_raw);
  const int row = blockIdx.x, tid = threadIdx.x, n_threads = blockDim.x;
  const T* xr = x + static_cast<size_t>(row) * k_in;
  int8_t* qr = q + static_cast<size_t>(row) * k_out;
  const int n_chunks = (k_out + kChunk - 1) / kChunk;
  // the chunks this thread holds in registers: tid, tid + n_threads, ...
  auto chunk = [&](int h) { return tid + h * n_threads; };

  int idx[kHeld][kChunk];
  float sc[kHeld][kChunk];
  if (kStaged) {  // (fused only) the x row into shared memory,
                           // behind the maxima, while the indices load
    T* xs = reinterpret_cast<T*>(smem_raw + kMaxThreads / 32 * sizeof(float));
    const int pieces = k_in * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < pieces; i += n_threads)
      ptx::cp_async<16>(reinterpret_cast<unsigned char*>(xs) + 16 * i,
                        reinterpret_cast<const unsigned char*>(xr) + 16 * i);
    ptx::cp_async_commit();
#pragma unroll
    for (int h = 0; h < kHeld; ++h)
      if (chunk(h) < n_chunks)
        load_map<kStaged>(gather, in_scale, chunk(h) * kChunk, k_out, idx[h], sc[h]);
    ptx::cp_async_wait<0>();
    __syncthreads();
    xr = xs;
  }
  float v[kHeld][kChunk];
  float amax = 0.f;
#pragma unroll
  for (int h = 0; h < kHeld; ++h) {
    if (chunk(h) >= n_chunks) continue;
    if (kStaged) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        v[h][e] = round_trip(__fmul_rn(to_float(xr[idx[h][e]]), sc[h][e]), xr);
    } else {
      body<T, kStaged>(xr, gather, in_scale, chunk(h) * kChunk, k_out, v[h]);
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e) amax = fmaxf(amax, fabsf(v[h][e]));
  }
  for (int c = chunk(kHeld); c < n_chunks; c += n_threads) {  // wide rows
    float w[kChunk];
    body<T, kStaged>(xr, gather, in_scale, c * kChunk, k_out, w);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) amax = fmaxf(amax, fabsf(w[e]));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
  for (int w = 1; w < n_threads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float qm = static_cast<float>(qmax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-9f), qm);
#pragma unroll
  for (int h = 0; h < kHeld; ++h)
    if (chunk(h) < n_chunks) store_chunk<kStaged>(qr, chunk(h) * kChunk, k_out, v[h], scale, qm);
  for (int c = chunk(kHeld); c < n_chunks; c += n_threads) {
    float w[kChunk];
    body<T, kStaged>(xr, gather, in_scale, c * kChunk, k_out, w);
    store_chunk<kStaged>(qr, c * kChunk, k_out, w, scale, qm);
  }
  if (tid == 0) s[row] = scale;
}

template <typename T, bool kStaged>
int launch(int m, int threads, cudaStream_t st, const void* x, const int* g,
           const float* sc, int8_t* q, float* s, int k_in, int k_out, int qmax) {
  static size_t opted_in = 48 << 10;
  const size_t smem = kMaxThreads / 32 * sizeof(float) + (kStaged ? k_in * sizeof(T) : 0);
  return klaunch::launch_kernel(rowwise_quantize_kernel<T, kStaged>, &opted_in,
                                dim3(m), threads, smem, st,
                                static_cast<const T*>(x), g, sc, q, s, k_in,
                                k_out, qmax);
}

template <typename T>
int launch_dtype(bool staged, int m, int threads, cudaStream_t st, const void* x,
                 const int* g, const float* sc, int8_t* q, float* s, int k_in,
                 int k_out, int qmax) {
  return staged ? launch<T, true>(m, threads, st, x, g, sc, q, s, k_in, k_out, qmax)
                : launch<T, false>(m, threads, st, x, g, sc, q, s, k_in, k_out, qmax);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  gather/in_scale may both be null
// (plain per-row quantization of x [m, k_in], k_out == k_in).
extern "C" int rowwise_quantize_launch(const void* x, const void* gather,
                                       const void* in_scale, void* q, void* s,
                                       int m, int k_in, int k_out, int qmax,
                                       int dtype, void* stream) {
  if (m == 0) return 0;
  if (k_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gather);
  const float* sc = static_cast<const float*>(in_scale);
  const int n_chunks = (k_out + kChunk - 1) / kChunk;
  int threads = 32;  // a chunk a thread, up to kHeld chunks from kMaxThreads on
  while (threads < n_chunks && threads < kMaxThreads) threads *= 2;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = k_in * (dtype == 0 ? 4 : 2);
  const bool staged = g != nullptr && k_out % kChunk == 0 && row_bytes % 16 == 0 &&
                      row_bytes <= kStageBytes && aligned16(q) && aligned16(g) &&
                      aligned16(sc) && aligned16(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  if (dtype == 0)
    return launch_dtype<float>(staged, m, threads, st, x, g, sc, qp, sp, k_in, k_out, qmax);
  return launch_dtype<__nv_bfloat16>(staged, m, threads, st, x, g, sc, qp, sp, k_in,
                                     k_out, qmax);
}
