// Paged attention over a block pool of KV pages (fp, int8 or int4 pages).
//
// Replaces: src/repro/kernels/paged_attention.py `_kernel` /
// `paged_attention_pallas` (Pallas), all three page modes.
//
// One block per (slot, kv-head).  The block holds the sq*g query rows of
// its group (row r sits at absolute position pos[b] + r / g), loads its
// own page ids from the page table and walks the slot's pages in order:
// each page (ps positions x dh) is read once from device memory,
// dequantized in the kernel into shared memory, and then every query row
// of the block consumes it with an online softmax (running max,
// denominator and un-normalized accumulator kept in shared memory, one
// warp per row).  Dequantization follows the plain version's order of
// operations and rounds to q's dtype as it does:
//   int8: code * f32 scale;
//   int4: channel d < dh/2 sits in the low nibble of byte d, channel
//         d >= dh/2 in the high nibble of byte d - dh/2 (half-split
//         layout); the nibble is sign-extended through int32 shifts
//         ((p << 28) >> 28, (p << 24) >> 28), multiplied by the bf16
//         scale as f32, then by the redistribution row redist[head, d]
//         (2^e on MUXQ outlier channels, 1 elsewhere).
// Pages past the block's last query position are fully masked and are not
// read; with NEG_INF = -1e9 (not -inf) a masked-only prefix stays finite,
// as in the reference, so slots that point at scratch page 0 give finite
// rows.  Causal plus sliding-window mask; optional softcap; the
// denominator is floored at 1e-30.
//
// Bound on an H100: bytes.  Decode (sq = 1, g = 1) does 4*dh operations
// per key for dh (int8: dh + 4; int4: dh/2 + 2) bytes, far under the
// card's balance point; speculative verify (sq = k) and chunked prefill
// (sq = 32) reuse each page for sq*g rows, still memory-bound at these
// widths.  Design for the bytes: the int8 or packed int4 codes are what
// crosses device memory, and each page is read once per (slot, head)
// whatever sq is.  The math is plain SIMT float32 in this version; with
// qwen2's g = 7 a prefill block has 224 rows over 4 warps, which is slow.
//
// Shared memory is 4 * (2*sq*g*dh + 2*sq*g + 2*ps*(dh + 1) + 128) bytes.
// Above 48 KB the launcher opts in with cudaFuncSetAttribute; above the
// card's 227 KB that call fails and its error is returned, never a
// silently skipped launch.
//
// The online-softmax update, the normalization and the launch are shared
// with flash_attention.cu (attention_common.cuh); this file stages pages.
#include "attention_common.cuh"

namespace {

using attn::to_float;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e9f;

// a dequantized value rounded to q's dtype, as the plain version casts it
template <typename QT>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// int4 code of channel d from the half-split packed row (sign-extended)
__device__ __forceinline__ float int4_code(const int8_t* row, int d,
                                           int half) {
  const bool lo = d < half;
  const unsigned p =
      static_cast<unsigned>(static_cast<int>(row[lo ? d : d - half]));
  return static_cast<float>(static_cast<int>(p << (lo ? 28 : 24)) >> 28);
}

template <typename QT, typename KT, bool kInt4>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const void* __restrict__ k_scale,
    const void* __restrict__ v_scale, const float* __restrict__ k_redist,
    const float* __restrict__ v_redist, const int* __restrict__ table,
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
  const int tid = threadIdx.x;

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
      float kv, vv;
      if constexpr (kInt4) {
        const int half = dh >> 1;
        const auto* kbs = static_cast<const __nv_bfloat16*>(k_scale);
        const auto* vbs = static_cast<const __nv_bfloat16*>(v_scale);
        kv = __fmul_rn(__fmul_rn(int4_code(k_pages + cell * half, d, half),
                                 __bfloat162float(kbs[cell])),
                       k_redist[hh * dh + d]);
        vv = __fmul_rn(__fmul_rn(int4_code(v_pages + cell * half, d, half),
                                 __bfloat162float(vbs[cell])),
                       v_redist[hh * dh + d]);
      } else {
        kv = to_float(k_pages[cell * dh + d]);
        vv = to_float(v_pages[cell * dh + d]);
        if (k_scale != nullptr) {
          kv = __fmul_rn(kv, static_cast<const float*>(k_scale)[cell]);
          vv = __fmul_rn(vv, static_cast<const float*>(v_scale)[cell]);
        }
      }
      ks[p * ldk + d] = round_to<QT>(kv);
      vs[p * ldk + d] = round_to<QT>(vv);
    }
    __syncthreads();
    attn::consume_tile<kWarps>(
        qs, acc, m_s, l_s, ks, vs, pbuf, rows, dh, ps, scale, softcap, kNegInf,
        [&](int r, int key) {
          const int qpos = p0 + r / g, kpos = j * ps + key;
          return kpos <= qpos && kpos > qpos - window;
        });
  }
  __syncthreads();
  for (int idx = tid; idx < rows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh, i = r / g, gg = r % g;
    attn::store_normalized(
        out + ((static_cast<size_t>(b) * sq + i) * h + hh * g + gg) * dh + d,
        acc, l_s, idx, r);
  }
}

template <typename QT, typename KT, bool kInt4 = false>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* kr, const void* vr, const void* table,
           const void* pos, void* out, int b, int sq, int h, int kvh, int dh,
           int ps, int n_table, int window, float scale, float softcap,
           cudaStream_t st) {
  const int rows = sq * (h / kvh);
  const size_t smem =
      sizeof(float) *
      (2 * rows * dh + 2 * rows + 2 * ps * (dh + 1) + kWarps * 32);
  static size_t opted_in = 48 * 1024;
  return attn::launch_kernel(
      paged_attention_kernel<QT, KT, kInt4>, &opted_in, dim3(b, kvh), kThreads,
      smem, st, static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), ks, vs, static_cast<const float*>(kr),
      static_cast<const float*>(vr), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<QT*>(out), sq, h, kvh, dh, ps,
      n_table, window, scale, softcap);
}

}  // namespace

// q [b, sq, h, dh] (q_dtype 0 = f32, 1 = bf16; out has q's dtype);
// pages [n_pages, ps, kvh, dh] (kv_dtype 0 = f32, 1 = bf16, 2 = int8 with
// f32 scales [n_pages, ps, kvh, 1]; 3 = int4: int8 [n_pages, ps, kvh, dh/2]
// packed bytes, bf16 scales [n_pages, ps, kvh, 1] and f32 redistribution
// rows k/v_redist [kvh, dh]; pointers a mode does not use are null); table
// [b, n_table] int32; pos [b] int32.  softcap <= 0 means none; ps <= 32.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_redist,
    const void* v_redist, const void* table, const void* pos, void* out,
    int b, int sq, int h, int kvh, int dh, int ps, int n_table, int window,
    float scale, float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                          \
  q, k_pages, v_pages, k_scale, v_scale, k_redist, v_redist, table, pos, \
      out, b, sq, h, kvh, dh, ps, n_table, window, scale, softcap, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch<float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch<float, __nv_bfloat16>(PA_ARGS);
    if (kv_dtype == 2) return launch<float, int8_t>(PA_ARGS);
    if (kv_dtype == 3) return launch<float, int8_t, true>(PA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch<__nv_bfloat16, float>(PA_ARGS);
    if (kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
    if (kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(PA_ARGS);
    if (kv_dtype == 3) return launch<__nv_bfloat16, int8_t, true>(PA_ARGS);
  }
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
