// Dense flash-attention forward: causal, GQA, optional sliding window and
// softcap.
//
// Replaces: src/repro/kernels/flash_attention.py `_kernel` /
// `flash_attention` (Pallas).
//
// One block per (query tile of kBq rows, query head, batch row).  The block
// computes its KV head as head / (h / kv), keeps its query tile and its
// online-softmax state (running max, denominator, un-normalized f32
// accumulator) in shared memory, and loops over key tiles of kBk = 32 keys:
// each K/V tile is read once from device memory into shared memory and
// consumed by every query row of the block, one warp per row, one key per
// lane for the scores, one head-dim channel per lane for P.V.  The TPU
// kernel's bq = bk = 128 VMEM tiling does not carry over: the tiles here
// fit a block's shared memory, and ragged edges (sq or sk not a multiple of
// the tile) are masked in the kernel.  Key tiles that no row of the block
// may attend (past its last causal position, or before its first window
// position) are skipped, which is exact: a row's masked keys get weight
// exp(NEG_INF - m) = 0 once it has seen a real key, as in the reference.
// Masked scores are NEG_INF = -1e30 (the reference's constant), keys past
// sk are -inf (they do not exist), and the denominator is floored at
// 1e-30.  Inputs f32 or bf16; math and accumulation in f32.
//
// Bound on an H100: operations.  4 * dh operations per (query, key) pair
// (half the pairs under a causal mask) against 2 * (sq + 2 * sk) * dh
// bytes per head: at sq = sk = 2048, dh = 64 that is about 340 operations
// per byte, above the card's balance point in bf16 and far above it in
// f32.  This version is plain SIMT f32 (no tensor cores, no copy
// pipeline), so it runs far from that bound; its design only keeps every
// K/V tile to one device-memory read per block.
//
// The online-softmax update, the normalization and the launch are shared
// with paged_attention.cu (attention_common.cuh); this file stages dense
// K/V tiles.
#include "attention_common.cuh"

namespace {

using attn::to_float;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBq = 32;       // query rows per block
constexpr int kBk = 32;       // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int h, int kv, int dh, int causal,
    int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBq, hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / (h / kv), ldk = dh + 1;
  const int rows = min(kBq, sq - q0);
  float* qs = smem;                   // [kBq][dh]
  float* acc = qs + kBq * dh;         // [kBq][dh]
  float* m_s = acc + kBq * dh;        // [kBq]
  float* l_s = m_s + kBq;             // [kBq]
  float* ks = l_s + kBq;              // [kBk][dh + 1]
  float* vs = ks + kBk * ldk;         // [kBk][dh + 1]
  float* pbuf = vs + kBk * ldk;       // [kWarps][32]
  const int tid = threadIdx.x;

  for (int idx = tid; idx < rows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh;
    qs[idx] = to_float(
        q[((static_cast<size_t>(b) * sq + q0 + r) * h + hh) * dh + d]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // key range some row of this block may attend
  const int q_last = q0 + rows - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = (k_begin / kBk) * kBk; kt < k_end; kt += kBk) {
    const int n_keys = min(kBk, sk - kt);
    __syncthreads();  // the previous tile is consumed (and state is set up)
    for (int idx = tid; idx < n_keys * dh; idx += kThreads) {
      const int p = idx / dh, d = idx % dh;
      const size_t off =
          ((static_cast<size_t>(b) * sk + kt + p) * kv + kvh) * dh + d;
      ks[p * ldk + d] = to_float(k[off]);
      vs[p * ldk + d] = to_float(v[off]);
    }
    __syncthreads();
    attn::consume_tile<kWarps>(
        qs, acc, m_s, l_s, ks, vs, pbuf, rows, dh, n_keys, scale, softcap,
        kNegInf, [&](int r, int key) {
          const int qpos = q0 + r, kpos = kt + key;
          return (!causal || kpos <= qpos) &&
                 (window <= 0 || kpos > qpos - window);
        });
  }
  __syncthreads();
  for (int idx = tid; idx < rows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh;
    attn::store_normalized(
        out + ((static_cast<size_t>(b) * sq + q0 + r) * h + hh) * dh + d, acc,
        l_s, idx, r);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int kv, int dh, int causal, int window,
           float scale, float softcap, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * kBq * dh + 2 * kBq + 2 * kBk * (dh + 1) + kWarps * 32);
  static size_t opted_in = 48 * 1024;
  return attn::launch_kernel(
      flash_attention_kernel<T>, &opted_in, dim3((sq + kBq - 1) / kBq, h, b),
      kThreads, smem, st, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, h, kv, dh,
      causal, window, scale, softcap);
}

}  // namespace

// q [b, sq, h, dh], k/v [b, sk, kv, dh], out like q; dtype 0 = f32,
// 1 = bf16 (all four alike).  h % kv == 0; causal 0/1; window <= 0 means
// none; softcap <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int sk, int h, int kv, int dh,
                                      int causal, int window, float scale,
                                      float softcap, int dtype, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, sq, sk, h, kv, dh, causal, window,
                         scale, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, h, kv, dh, causal,
                                 window, scale, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
