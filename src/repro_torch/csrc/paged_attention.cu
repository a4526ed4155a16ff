// Paged attention over a block pool of KV pages (fp or int8 pages).
//
// Replaces: src/repro/kernels/paged_attention.py `_kernel` /
// `paged_attention_pallas` (Pallas), fp and int8 page modes.  The int4
// nibble mode of that kernel is not ported yet.
//
// One block per (slot, kv-head).  The block holds the sq*g query rows of
// its group (row r sits at absolute position pos[b] + r / g), loads its
// own page ids from the page table and walks the slot's pages in order:
// each page (ps positions x dh) is read once from device memory,
// dequantized in the kernel (int8 codes times the per-(position, head) f32
// scale) into shared memory, and then every query row of the block
// consumes it with an online softmax (running max, denominator and
// un-normalized accumulator kept in shared memory, one warp per row).
// Pages past the block's last query position are fully masked and are not
// read; with NEG_INF = -1e9 (not -inf) a masked-only prefix stays finite,
// as in the reference, so slots that point at scratch page 0 give finite
// rows.  Causal plus sliding-window mask; optional softcap; the
// denominator is floored at 1e-30.
//
// Bound on an H100: bytes.  Decode (sq = 1, g = 1) does 4*dh operations
// per key for dh (int8: dh + 4) bytes, far under the card's balance point;
// chunked prefill (sq = 32) reuses each page for 32 rows, still
// memory-bound at these widths.  Design for the bytes: the int8 codes are
// what crosses device memory and each page is read once per (slot, head)
// whatever sq is.  The math is plain SIMT float32 in this version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e9f;

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

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ pos, QT* __restrict__ out, int sq, int h,
    int kvh, int dh, int ps, int n_table, int window, float scale,
    float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hh = blockIdx.y;
  const int g = h / kvh, rows = sq * g, ldk = dh + 1;
  float* qs = smem;                   // [rows][dh]
  float* acc = qs + rows * dh;        // [rows][dh]
  float* m_s = acc + rows * dh;       // [rows]
  float* l_s = m_s + rows;            // [rows]
  float* ks = l_s + rows;             // [ps][dh + 1]
  float* vs = ks + ps * ldk;          // [ps][dh + 1]
  float* pbuf = vs + ps * ldk;        // [kWarps][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // row r = i * g + gg  <->  query token i, head hh * g + gg
  for (int idx = tid; idx < rows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh, i = r / g, gg = r % g;
    qs[idx] = to_float(q[((static_cast<size_t>(b) * sq + i) * h + hh * g + gg) *
                             dh + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int p0 = pos[b];
  const int last = p0 + sq - 1;  // the block's last query position
  const int n_read = min(n_table, last / ps + 1);
  for (int j = 0; j < n_read; ++j) {
    const int pid = table[static_cast<size_t>(b) * n_table + j];
    __syncthreads();  // the previous page is consumed (and state is set up)
    for (int idx = tid; idx < ps * dh; idx += kThreads) {
      const int p = idx / dh, d = idx % dh;
      const size_t cell = (static_cast<size_t>(pid) * ps + p) * kvh + hh;
      float kv = to_float(k_pages[cell * dh + d]);
      float vv = to_float(v_pages[cell * dh + d]);
      if (k_scale != nullptr) {
        kv = __fmul_rn(kv, k_scale[cell]);
        vv = __fmul_rn(vv, v_scale[cell]);
      }
      ks[p * ldk + d] = kv;
      vs[p * ldk + d] = vv;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const int qpos = p0 + r / g;
      float s = -INFINITY;  // lanes past the page: no key at all
      if (lane < ps) {
        const float* qr = qs + r * dh;
        const float* kr = ks + lane * ldk;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kpos = j * ps + lane;
        const bool allow = kpos <= qpos && kpos > qpos - window;
        s = allow ? s : kNegInf;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < ps ? expf(s - m_new) : 0.f;
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
        for (int kp = 0; kp < ps; ++kp)
          a = fmaf(pbuf[warp * 32 + kp], vs[kp * ldk + d], a);
        acc[r * dh + d] = a;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh, i = r / g, gg = r % g;
    const float denom = fmaxf(l_s[r], 1e-30f);
    store(out + ((static_cast<size_t>(b) * sq + i) * h + hh * g + gg) * dh + d,
          acc[idx] / denom);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* pos, void* out,
           int b, int sq, int h, int kvh, int dh, int ps, int n_table,
           int window, float scale, float softcap, cudaStream_t st) {
  const int rows = sq * (h / kvh);
  const size_t smem =
      sizeof(float) *
      (2 * rows * dh + 2 * rows + 2 * ps * (dh + 1) + kWarps * 32);
  auto kern = paged_attention_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(b, kvh);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<QT*>(out), sq, h, kvh, dh, ps,
      n_table, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, sq, h, dh] (q_dtype 0 = f32, 1 = bf16; out has q's dtype);
// pages [n_pages, ps, kvh, dh] (kv_dtype 0 = f32, 1 = bf16, 2 = int8 with
// f32 scales [n_pages, ps, kvh, 1]; scales null otherwise); table
// [b, n_table] int32; pos [b] int32.  softcap <= 0 means none; ps <= 32.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* pos, void* out, int b, int sq, int h, int kvh, int dh, int ps,
    int n_table, int window, float scale, float softcap, int q_dtype,
    int kv_dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                              \
  q, k_pages, v_pages, k_scale, v_scale, table, pos, out, b, sq, h, kvh, dh, \
      ps, n_table, window, scale, softcap, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch<float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch<float, __nv_bfloat16>(PA_ARGS);
    if (kv_dtype == 2) return launch<float, int8_t>(PA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch<__nv_bfloat16, float>(PA_ARGS);
    if (kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
    if (kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(PA_ARGS);
  }
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
