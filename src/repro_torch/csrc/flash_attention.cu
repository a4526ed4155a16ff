// Dense flash-attention forward: causal, GQA, optional sliding window and
// softcap.
//
// Replaces: src/repro/kernels/flash_attention.py `_kernel` /
// `flash_attention` (Pallas).
//
// Work: query tiles of 64 rows, one per (tile, query head, batch row),
// taken from a queue, the tiles with the most keys under a causal mask
// first, by a grid of at most 2 blocks a SM.  A query tile is 4 warps of
// 16 rows each, the core of attention_common.cuh (bf16 MMA for bf16
// inputs, unrolled fmaf chains on the CUDA cores for f32), with the
// online-softmax state (running max, denominator, un-normalized f32 output)
// in registers.  The block computes its KV head as head / (h / kv) and
// walks key tiles of kBk keys (64 at head dim 64, 32 up to 128, 16 up to
// 256) through a two-stage cp.async buffer: the next K/V tile is in
// flight while the current one is consumed.  The TPU kernel's bq = bk = 128 VMEM tiling does not carry
// over: the tiles here fit a block's shared memory and the MMA's 16-row
// fragments, and ragged edges (sq or sk not a multiple of the tile) are
// masked in the kernel (missing keys score -inf and their V rows are
// zero).  Key tiles that no row of the block may attend (past its last
// causal position, or before its first window position) are skipped,
// which is exact: a row's masked keys get weight exp(NEG_INF - m) = 0 once
// it has seen a real key, as in the reference.  A block with a row that
// has no key at all (a window, and sq > sk) reads every tile: such a row
// averages V over all sk keys.  Masked scores are
// NEG_INF = -1e30 (the reference's constant), and the denominator is
// floored at 1e-30.  A key tile that every row of the query tile may
// attend skips the mask.  The K/V tile is not shared across the query
// heads of a GQA group: each block reads its own.
//
// Bound on an H100: operations.  4 * dh operations per (query, key) pair
// (half the pairs under a causal mask) against 2 * (sq + 2 * sk) * dh
// bytes per head: at sq = sk = 2048, dh = 64 that is about 340 operations
// per byte, above the card's balance point in bf16 (989 TFLOP/s) and far
// above it in f32 on the CUDA cores (67 TFLOP/s).
//
// Shared memory per block: sizeof(T) * (64 + 4 kBk) * kLd bytes (query
// tile, two stages of K and V; kLd = kDh + 4 for f32, kDh + 8 for bf16):
// 46 KB in bf16 and 87 KB in f32 at head dim 64.
//
// Left for a wgmma/TMA version: 64-row warpgroup MMA straight from shared
// memory, TMA tile loads with mbarriers and a producer warp, and K/V
// tiles shared by the heads of a GQA group.
#include "attention_common.cuh"

namespace {

using attn::kRows;
using attn::kThreads;

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int* next;  // the work queue's counter, zero at launch
  int b, sq, sk, h, kv, dh, causal, window;
  int row_bytes;  // bytes of one K or V row (dh elements)
  int chunk;      // cp.async size for those rows (0: plain loads)
  float scale, softcap;
};

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int kBk = attn::key_tile<kDh>();
  constexpr int kLd = attn::tile_ld<T, kDh>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kLd]
  T* kv_tiles = qs + kRows * kLd;           // [2][K, V][kBk][kLd]
  int* item_s = reinterpret_cast<int*>(kv_tiles + 4 * kBk * kLd);
  const int tid = threadIdx.x, warp = tid >> 5, dh = p.dh;
  const int n_qt = (p.sq + kRows - 1) / kRows;
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v);
  const unsigned char* qbase = static_cast<const unsigned char*>(p.q);

  // channels dh..kDh of every tile stay zero
  if (dh < kDh)
    for (int idx = tid; idx < (kRows + 4 * kBk) * kDh; idx += kThreads) {
      const int r = idx / kDh, d = idx % kDh;
      if (d >= dh) attn::store(qs + r * kLd + d, 0.f);
    }

  // One query tile of 64 rows from q0 of head hh, batch row b: the whole
  // online softmax.
  auto process = [&](int q0, int hh, int b) {
    const int kvh = hh / (p.h / p.kv);
    const int rows = min(kRows, p.sq - q0);
    // key range some row of this tile may attend.  A row at or past
    // sk - 1 + window has every key masked and averages V over all sk
    // keys, as the reference does, so then no leading tile is skipped.
    const int q_last = q0 + rows - 1;
    const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
    const bool all_masked_row = p.window > 0 && q_last - p.window >= p.sk - 1;
    const int k_begin =
        p.window > 0 && !all_masked_row ? max(0, q0 - p.window + 1) : 0;
    const int first = k_begin / kBk * kBk;
    const int n_tiles = k_end > first ? (k_end - first + kBk - 1) / kBk : 0;

    // K/V rows of tile `it` into stage `it % 2`; rows past sk are zero
    auto issue = [&](int it) {
      const int kt = first + it * kBk, nk = min(kBk, p.sk - kt);
      T* kt_s = kv_tiles + (it & 1) * 2 * kBk * kLd;
      T* vt_s = kt_s + kBk * kLd;
      const size_t row0 = (static_cast<size_t>(b) * p.sk + kt) * p.kv + kvh;
      attn::copy_rows(reinterpret_cast<unsigned char*>(kt_s), kLd * sizeof(T),
                      nk, p.row_bytes, p.chunk, [&](int r) {
                        return kbase + (row0 + static_cast<size_t>(r) * p.kv) *
                                           p.row_bytes;
                      });
      attn::copy_rows(reinterpret_cast<unsigned char*>(vt_s), kLd * sizeof(T),
                      nk, p.row_bytes, p.chunk, [&](int r) {
                        return vbase + (row0 + static_cast<size_t>(r) * p.kv) *
                                           p.row_bytes;
                      });
      for (int idx = tid; idx < (kBk - nk) * dh; idx += kThreads) {
        const int r = nk + idx / dh, d = idx % dh;
        attn::store(kt_s + r * kLd + d, 0.f);
        attn::store(vt_s + r * kLd + d, 0.f);
      }
      ptx::cp_async_commit();
    };

    // the query tile (rows past sq are zero) travels with the first K/V tile
    attn::copy_rows(reinterpret_cast<unsigned char*>(qs), kLd * sizeof(T), rows,
                    p.row_bytes, p.chunk, [&](int r) {
                      return qbase + ((static_cast<size_t>(b) * p.sq + q0 + r) *
                                          p.h + hh) *
                                         static_cast<size_t>(p.row_bytes);
                    });
    for (int idx = tid; idx < (kRows - rows) * dh; idx += kThreads)
      attn::store(qs + (rows + idx / dh) * kLd + idx % dh, 0.f);
    if (n_tiles > 0) issue(0);
    else ptx::cp_async_commit();

    attn::WarpTile<T, kDh> st;
    st.init(kNegInf);
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[i] = q0 + attn::WarpTile<T, kDh>::row(i);

    for (int it = 0; it < n_tiles; ++it) {
      const int kt = first + it * kBk, nk = min(kBk, p.sk - kt);
      if (it + 1 < n_tiles) {
        issue(it + 1);
        ptx::cp_async_wait<1>();
      } else {
        ptx::cp_async_wait<0>();
      }
      __syncthreads();  // tile it (and the query tile) has landed
      if (warp * 16 < rows) {
        const T* kt_s = kv_tiles + (it & 1) * 2 * kBk * kLd;
        const T* qw = qs + warp * 16 * kLd;
        // every row of the tile may attend every key of this tile: no mask
        const bool open = (!p.causal || kt + nk - 1 <= q0) &&
                          (p.window <= 0 || kt > q_last - p.window);
        if (open) {
          st.consume(qw, kt_s, kt_s + kBk * kLd, nk, p.scale, p.softcap,
                     kNegInf, [](int, int) { return true; });
        } else {
          st.consume(qw, kt_s, kt_s + kBk * kLd, nk, p.scale, p.softcap,
                     kNegInf, [&](int i, int key) {
                       const int kpos = kt + key;
                       return (!p.causal || kpos <= qpos[i]) &&
                              (p.window <= 0 || kpos > qpos[i] - p.window);
                     });
        }
      }
      __syncthreads();  // tile it is consumed before its stage is refilled
    }
    if (n_tiles == 0) {
      ptx::cp_async_wait<0>();
      __syncthreads();
    }

    if (warp * 16 < rows) {
      st.finish();
      T* out = static_cast<T*>(p.out);
      st.for_each([&](int i, int d, float v) {
        const int r = attn::WarpTile<T, kDh>::row(i);
        if (r < rows && d < dh)
          attn::store(out + ((static_cast<size_t>(b) * p.sq + q0 + r) * p.h + hh) *
                                dh + d,
                      v / fmaxf(st.l[i], 1e-30f));
      });
    }
    __syncthreads();  // the query tile is free for the next one
  };

  // Work queue: item i is query tile n_qt - 1 - i / (h b), the last tiles
  // (the most key tiles under a causal mask) first, of head and batch row
  // i % (h b).  Each block takes the next item when it is done with one.
  const int n_items = n_qt * p.h * p.b;
  for (;;) {
    if (tid == 0) *item_s = atomicAdd(p.next, 1);
    __syncthreads();
    const int item = *item_s;
    if (item >= n_items) break;
    const int hb = item % (p.h * p.b);
    process((n_qt - 1 - item / (p.h * p.b)) * kRows, hb % p.h, hb / p.h);
  }
}

// At most kBlocksPerSm blocks on each SM (fewer where the occupancy is
// lower), at most one per item; the queue's counter is zeroed first, in
// the stream.  With fewer blocks than items, a block that finishes early
// takes the next item, so the causal mask's uneven tiles even out; with
// every item resident at once, or with paired tiles, the H100 took longer
// (tools/attention_probe.py times the alternatives).
constexpr int kBlocksPerSm = 2;
template <typename T, int kDh>
int launch(const Params& p, cudaStream_t st) {
  constexpr int kBk = attn::key_tile<kDh>();
  const size_t smem =
      sizeof(T) * (kRows + 4 * kBk) * attn::tile_ld<T, kDh>() + 16;
  static size_t opted_in = 48 * 1024;
  static int resident = 0;  // blocks the card holds at once
  const auto kern = flash_attention_kernel<T, kDh>;
  int rc = attn::opt_in(kern, &opted_in, smem);
  if (rc != 0) return rc;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                  smem);
    resident = sms * min(per_sm, kBlocksPerSm);
    if (resident <= 0) return static_cast<int>(cudaGetLastError());
  }
  const int n_items = (p.sq + kRows - 1) / kRows * p.h * p.b;
  rc = static_cast<int>(cudaMemsetAsync(p.next, 0, sizeof(int), st));
  if (rc != 0) return rc;
  return attn::launch_kernel(kern, &opted_in, dim3(min(n_items, resident)),
                             kThreads, smem, st, p);
}

template <typename T>
int launch_dh(const Params& p, cudaStream_t st) {
  if (p.dh <= 64) return launch<T, 64>(p, st);
  if (p.dh <= 128) return launch<T, 128>(p, st);
  return launch<T, 256>(p, st);
}

}  // namespace

// q [b, sq, h, dh], k/v [b, sk, kv, dh], out like q; dtype 0 = f32,
// 1 = bf16 (all four alike).  h % kv == 0; dh <= 256; causal 0/1;
// window <= 0 means none; softcap <= 0 means none.  `next` is one int32
// of scratch (the work queue's counter).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* next,
                                      int b, int sq, int sk, int h, int kv,
                                      int dh, int causal, int window,
                                      float scale, float softcap, int dtype,
                                      void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0 || dh <= 0 || dh > 256 || sk < 0 ||
      next == nullptr || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, static_cast<int*>(next), b, sq, sk, h, kv, dh,
           causal, window};
  p.row_bytes = dh * (dtype == 0 ? 4 : 2);
  p.chunk = attn::copy_chunk(p.row_bytes, {q, k, v});
  p.scale = scale, p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(p, st);
  return launch_dh<__nv_bfloat16>(p, st);
}
