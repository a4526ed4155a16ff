// Paged attention over a block pool of KV pages (fp, int8 or int4 pages).
//
// Replaces: src/repro/kernels/paged_attention.py `_kernel` /
// `paged_attention_pallas` (Pallas), all three page modes.
//
// Query rows: slot b, KV head hh holds the sq * g rows r = i * g + gg
// (query token i at absolute position pos[b] + i, query head hh * g + gg).
// Grid: (KV split, row tile, slot x KV head).  A block takes one tile of
// up to 64 of those rows (4 warps x 16, the MMA row tile of
// attention_common.cuh; a ragged last tile is masked) and one split of the
// slot's page table: pages [split * pps, split * pps + pps).  Only the
// table's width n_table is known on the host (pos stays on the card: no
// host sync, and the launch can be captured in a CUDA graph), so the
// wrapper picks the split from n_table and the grid; the block reads pos
// and stops at the row tile's last page (last / ps + 1, last the tile's
// last query position): the pages after it are fully masked for every row
// of the tile, and skipping them is exact.  A split past that page writes
// an empty partial (m = -inf, l = 0).
//
// Each block walks its split in key tiles of kBk positions (64 at dh 64),
// through a double buffer: while one tile is dequantized and consumed, the
// next tile's page rows (raw codes, read once per (slot, head, row tile))
// are in flight with cp.async, and its scales in registers.  Dequantization
// runs from shared memory into the K/V tile, in the plain version's order
// of operations, and rounds to q's dtype as it does:
//   int8: code * f32 scale (__fmul_rn);
//   int4: channel d < dh/2 sits in the low nibble of byte d, channel
//         d >= dh/2 in the high nibble of byte d - dh/2 (half-split
//         layout); the nibble is sign-extended through int32 shifts
//         ((p << 28) >> 28, (p << 24) >> 28), multiplied by the bf16
//         scale as f32, then by the redistribution row redist[head, d]
//         (2^e on MUXQ outlier channels, 1 elsewhere).
// The tile update is the shared core (attention_common.cuh): bf16 MMA for
// bf16 q, fmaf chains on the CUDA cores for f32 q.  Causal plus sliding-window
// mask; optional softcap; NEG_INF = -1e9 (finite, as in the reference), so
// rows of slots that point at scratch page 0 stay finite.
//
// Split-KV: with one split the block normalizes and writes the output;
// when its rows' keys also fit one tile (a table of at most one tile is
// never split), the f32 path normalizes the probabilities before P.V the
// way the plain version does (attention_common.cuh, `whole`), and its
// output is the plain version's own arithmetic.
// With several, each block writes its partial (m, l, un-normalized O) in
// f32 to the wrapper's scratch, and a second launch from the same C call
// merges them: M = max m over the non-empty splits, w = exp(m - M),
// out = sum w O / max(sum w l, 1e-30).  An empty split is skipped, never
// weighed, so exp(-inf - -inf) is never evaluated.
//
// Bound on an H100: bytes at decode and verify (a decode row does 4 dh
// operations per key for 2 dh (int8: 2 (dh + 4); int4: 2 (dh/2 + 2))
// bytes of page, far under the card's balance point); a prefill chunk of
// sq * g rows reuses each page that many times and still stays near it.
// Design for the bytes and for the SMs: the page codes are what crosses
// device memory, read once per (slot, head, row tile); the KV split gives
// decode b * kvh * splits blocks instead of b * kvh (qwen2: 64 on 8 pages
// of 16 rather than 8).
//
// Shared memory per block (bytes, kBk = 4096 / kDh, kDh = dh rounded up
// to 64, 128 or 256, kLd = kDh + 4 (f32 q) or kDh + 8 (bf16 q), raw_ld =
// a page row's bytes rounded up to 16):
//   sizeof(q) * (64 + 2 kBk) * kLd    query tile, K and V tiles
//   + 4 kBk raw_ld                    two stages of raw K and V rows
//   + 4 (2 kBk + 2 kDh) + 4 pps       scales, redist rows, page ids
// It no longer grows with sq * g: at dh 64, 60 KB for int4 pages under
// f32 q, 118 KB for f32 pages under f32 q.  Above 48 KB the launcher opts
// in with cudaFuncSetAttribute; a refusal is returned as an error.
//
// Left for a wgmma/TMA version: TMA page copies behind mbarriers, a
// producer warp that dequantizes while consumer warps run wgmma, and one
// block serving all row tiles of a (slot, head) to read each page once.
#include "attention_common.cuh"

namespace {

using attn::kRows;
using attn::kThreads;
using attn::to_float;

constexpr float kNegInf = -1e9f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const void* k_scale;
  const void* v_scale;
  const float* k_redist;
  const float* v_redist;
  const int* table;
  const int* pos;
  void* out;
  float* ws;  // split partials: O [n_split][b][kvh][rows_pad][dh], m, l
  int b, sq, h, kvh, dh, ps, n_table, window, pps, n_split;
  int rows_pad;   // row tiles x 64
  int row_bytes;  // bytes of one (page, position, head) row of codes
  int raw_ld;     // row_bytes rounded up to 16
  int chunk;      // cp.async size for those rows (0: plain loads)
  int q_chunk;    // cp.async size for q's rows
  float scale, softcap;
};

// int4 code of channel d from the half-split packed row (sign-extended)
__device__ __forceinline__ float int4_code(const int8_t* row, int d,
                                           int half) {
  const bool lo = d < half;
  const unsigned p =
      static_cast<unsigned>(static_cast<int>(row[lo ? d : d - half]));
  return static_cast<float>(static_cast<int>(p << (lo ? 28 : 24)) >> 28);
}

template <typename QT, typename KT, bool kInt4, int kDh>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Params p) {
  constexpr int kBk = attn::key_tile<kDh>();
  constexpr int kLd = attn::tile_ld<QT, kDh>();
  constexpr bool kScaled = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QT* qs = reinterpret_cast<QT*>(smem_raw);  // [kRows][kLd]
  QT* ks = qs + kRows * kLd;                  // [kBk][kLd]
  QT* vs = ks + kBk * kLd;                    // [kBk][kLd]
  unsigned char* raw =
      reinterpret_cast<unsigned char*>(vs + kBk * kLd);  // [2][K, V][kBk][raw_ld]
  float* sc = reinterpret_cast<float*>(raw + 4 * kBk * p.raw_ld);  // [K, V][kBk]
  float* red = sc + 2 * kBk;                          // [K, V][kDh]
  int* ids = reinterpret_cast<int*>(red + 2 * kDh);  // [pps]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int sp = blockIdx.x, rt = blockIdx.y;
  const int b = blockIdx.z / p.kvh, hh = blockIdx.z % p.kvh;
  const int dh = p.dh, ps = p.ps, g = p.h / p.kvh, rows = p.sq * g;
  const int r_begin = rt * kRows, rows_t = min(kRows, rows - r_begin);
  const int j_begin = sp * p.pps;
  const int p0 = p.pos[b];  // in flight while the ids and the queries load

  // the split's page ids (up to the table's end; pos trims them below)
  for (int j = tid; j < min(p.pps, p.n_table - j_begin); j += kThreads)
    ids[j] = p.table[static_cast<size_t>(b) * p.n_table + j_begin + j];
  // the query rows r_begin.. of the tile (row r = i * g + gg: token i, head
  // hh * g + gg), asynchronously, with the first page tile; rows past the
  // slot's and channels past dh are zero
  const unsigned char* qbase = static_cast<const unsigned char*>(p.q);
  attn::copy_rows(reinterpret_cast<unsigned char*>(qs), kLd * sizeof(QT), rows_t,
                  dh * static_cast<int>(sizeof(QT)), p.q_chunk, [&](int r) {
                    const int R = r_begin + r;
                    return qbase + ((static_cast<size_t>(b) * p.sq + R / g) * p.h +
                                    hh * g + R % g) *
                                       dh * sizeof(QT);
                  });
  for (int idx = tid; idx < (kRows - rows_t) * kDh; idx += kThreads)
    if (idx % kDh < dh)
      attn::store(qs + (rows_t + idx / kDh) * kLd + idx % kDh, 0.f);
  if (dh < kDh)
    for (int idx = tid; idx < (kRows + 2 * kBk) * kDh; idx += kThreads)
      if (idx % kDh >= dh) attn::store(qs + idx / kDh * kLd + idx % kDh, 0.f);
  if constexpr (kInt4) {
    for (int d = tid; d < kDh; d += kThreads) {
      red[d] = d < dh ? p.k_redist[hh * dh + d] : 0.f;
      red[kDh + d] = d < dh ? p.v_redist[hh * dh + d] : 0.f;
    }
  }

  const int last = p0 + (r_begin + rows_t - 1) / g;  // tile's last position
  const int n_read = min(p.n_table, last / ps + 1);
  const int j_end = min(j_begin + p.pps, n_read);
  const size_t plane = static_cast<size_t>(p.b) * p.kvh * p.rows_pad;
  const size_t row0 = static_cast<size_t>(sp) * plane +
                      static_cast<size_t>(blockIdx.z) * p.rows_pad + r_begin;
  float* ws_m = p.ws + static_cast<size_t>(p.n_split) * plane * dh;
  float* ws_l = ws_m + static_cast<size_t>(p.n_split) * plane;
  if (p.n_split > 1 && j_begin >= j_end) {  // an empty split
    // the query rows must land before the block's shared memory is freed:
    // wait_group waits only for committed groups
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    for (int r = tid; r < rows_t; r += kThreads) {
      ws_m[row0 + r] = -INFINITY;
      ws_l[row0 + r] = 0.f;
    }
    return;
  }
  __syncthreads();  // page ids (and the rest) are set up

  // the split's key positions [key_begin, key_end), in tiles of kBk
  const int key_begin = j_begin * ps, key_end = max(j_end, j_begin) * ps;
  const int n_tiles = (key_end - key_begin + kBk - 1) / kBk;
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k_pages);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v_pages);
  float pending = 0.f;  // the next tile's scale held by this thread

  // page rows of tile `it` into stage `it % 2`; its scales into `pending`
  auto issue = [&](int it) {
    const int t0 = key_begin + it * kBk, nk = min(kBk, key_end - t0);
    unsigned char* rk = raw + (it & 1) * 2 * kBk * p.raw_ld;
    const auto cell = [&](int kk) {
      const int P = t0 + kk;
      return (static_cast<size_t>(ids[P / ps - j_begin]) * ps + P % ps) * p.kvh + hh;
    };
    attn::copy_rows(rk, p.raw_ld, nk, p.row_bytes, p.chunk, [&](int kk) {
      return kbase + cell(kk) * p.row_bytes;
    });
    attn::copy_rows(rk + kBk * p.raw_ld, p.raw_ld, nk, p.row_bytes, p.chunk,
                    [&](int kk) { return vbase + cell(kk) * p.row_bytes; });
    if constexpr (kScaled) {
      const int kk = tid % kBk;
      if (tid < 2 * kBk && kk < nk) {
        const void* s = tid < kBk ? p.k_scale : p.v_scale;
        if constexpr (kInt4)
          pending = __bfloat162float(static_cast<const __nv_bfloat16*>(s)[cell(kk)]);
        else
          pending = static_cast<const float*>(s)[cell(kk)];
      }
    }
    ptx::cp_async_commit();
  };

  attn::WarpTile<QT, kDh, true> st;
  st.init(kNegInf);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = p0 + (r_begin + attn::WarpTile<QT, kDh, true>::row(i)) / g;

  if (n_tiles > 0) issue(0);
  else ptx::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = key_begin + it * kBk, nk = min(kBk, key_end - t0);
    if constexpr (kScaled) {
      if (tid < 2 * kBk) sc[tid] = pending;  // tile it's scales
    }
    if (it + 1 < n_tiles) {
      issue(it + 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();  // tile it's rows have landed; tile it - 1 is consumed
    const unsigned char* rk = raw + (it & 1) * 2 * kBk * p.raw_ld;
    const unsigned char* rv = rk + kBk * p.raw_ld;
    // rows past nk, up to the 16 keys an MMA step reads, are zero
    const int n_rows = min(kBk, (nk + 15) / 16 * 16);
#pragma unroll 4
    for (int idx = tid; idx < n_rows * kDh; idx += kThreads) {
      const int kk = idx / kDh, d = idx % kDh;
      if (d >= dh) continue;
      float kv = 0.f, vv = 0.f;
      if (kk < nk) {
        const unsigned char* kr = rk + kk * p.raw_ld;
        const unsigned char* vr = rv + kk * p.raw_ld;
        if constexpr (kInt4) {
          const int half = dh >> 1;
          kv = __fmul_rn(__fmul_rn(int4_code(reinterpret_cast<const int8_t*>(kr), d, half),
                                   sc[kk]),
                         red[d]);
          vv = __fmul_rn(__fmul_rn(int4_code(reinterpret_cast<const int8_t*>(vr), d, half),
                                   sc[kBk + kk]),
                         red[kDh + d]);
        } else {
          kv = to_float(reinterpret_cast<const KT*>(kr)[d]);
          vv = to_float(reinterpret_cast<const KT*>(vr)[d]);
          if constexpr (kScaled) {
            kv = __fmul_rn(kv, sc[kk]);
            vv = __fmul_rn(vv, sc[kBk + kk]);
          }
        }
      }
      attn::store(ks + kk * kLd + d, kv);  // rounds to q's dtype
      attn::store(vs + kk * kLd + d, vv);
    }
    __syncthreads();
    if (warp * 16 < rows_t) {
      st.consume(qs + warp * 16 * kLd, ks, vs, nk, p.scale, p.softcap, kNegInf,
                 [&](int i, int key) {
                   const int kpos = t0 + key;
                   return kpos <= qpos[i] && kpos > qpos[i] - p.window;
                 },
                 p.n_split == 1 && n_tiles == 1);
    }
  }
  if (n_tiles == 0) {
    ptx::cp_async_wait<0>();
    __syncthreads();
  }

  if (warp * 16 >= rows_t) return;
  st.finish();
  const int t = tid & 3;
  if (p.n_split == 1) {
    QT* out = static_cast<QT*>(p.out);
    st.for_each([&](int i, int d, float v) {
      const int r = attn::WarpTile<QT, kDh, true>::row(i), R = r_begin + r;
      if (r < rows_t && d < dh) {
        const int qi = R / g, gg = R % g;
        attn::store(out + ((static_cast<size_t>(b) * p.sq + qi) * p.h + hh * g + gg) *
                              dh + d,
                    v / fmaxf(st.l[i], 1e-30f));
      }
    });
  } else {
    st.for_each([&](int i, int d, float v) {
      const int r = attn::WarpTile<QT, kDh, true>::row(i);
      if (r < rows_t && d < dh) p.ws[(row0 + r) * dh + d] = v;
    });
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = attn::WarpTile<QT, kDh, true>::row(i);
      if (t == 0 && r < rows_t) {
        ws_m[row0 + r] = st.m[i];
        ws_l[row0 + r] = st.l[i];
      }
    }
  }
}

// Merge the splits' partials of one (slot, KV head): one thread per
// (row, channel) of the output.
template <typename QT>
__global__ void __launch_bounds__(256)
    combine_kernel(const float* __restrict__ ws, QT* __restrict__ out,
                   int b_total, int sq, int h, int kvh, int dh, int rows_pad,
                   int n_split) {
  const int z = blockIdx.y, b = z / kvh, hh = z % kvh, g = h / kvh;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= sq * g * dh) return;
  const int r = idx / dh, d = idx % dh;
  const size_t plane = static_cast<size_t>(b_total) * kvh * rows_pad;
  const size_t row = static_cast<size_t>(z) * rows_pad + r;
  const float* ws_m = ws + static_cast<size_t>(n_split) * plane * dh;
  const float* ws_l = ws_m + static_cast<size_t>(n_split) * plane;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ws_m[s * plane + row]);
  float l = 0.f, o = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    // loaded unconditionally, so that the loads of 8 splits overlap; an
    // empty split's O was never written and is never weighed
    const float ms = ws_m[s * plane + row], ls = ws_l[s * plane + row];
    const float os = ws[(s * plane + row) * dh + d];
    if (ms != -INFINITY) {
      const float w = expf(ms - mx);
      l += w * ls;
      o += w * os;
    }
  }
  const int i = r / g, gg = r % g;
  attn::store(out + ((static_cast<size_t>(b) * sq + i) * h + hh * g + gg) * dh + d,
              o / fmaxf(l, 1e-30f));
}

template <typename QT, typename KT, bool kInt4, int kDh>
int launch(const Params& p, cudaStream_t st) {
  constexpr int kBk = attn::key_tile<kDh>();
  constexpr int kLd = attn::tile_ld<QT, kDh>();
  const int rows = p.sq * (p.h / p.kvh);
  const size_t smem = sizeof(QT) * (kRows + 2 * kBk) * kLd +
                      4 * static_cast<size_t>(kBk) * p.raw_ld +
                      sizeof(float) * (2 * kBk + 2 * kDh) +
                      sizeof(int) * static_cast<size_t>(p.pps);
  static size_t opted_in = 48 * 1024;
  const int rc = attn::launch_kernel(
      paged_attention_kernel<QT, KT, kInt4, kDh>, &opted_in,
      dim3(p.n_split, p.rows_pad / kRows, p.b * p.kvh), kThreads, smem, st, p);
  if (rc != 0 || p.n_split == 1) return rc;
  static size_t combine_opted_in = 48 * 1024;
  return attn::launch_kernel(combine_kernel<QT>, &combine_opted_in,
                             dim3((rows * p.dh + 255) / 256, p.b * p.kvh), 256,
                             0, st, static_cast<const float*>(p.ws),
                             static_cast<QT*>(p.out), p.b, p.sq, p.h, p.kvh,
                             p.dh, p.rows_pad, p.n_split);
}

template <typename QT, typename KT, bool kInt4 = false>
int launch_dh(const Params& p, cudaStream_t st) {
  if (p.dh <= 64) return launch<QT, KT, kInt4, 64>(p, st);
  if (p.dh <= 128) return launch<QT, KT, kInt4, 128>(p, st);
  return launch<QT, KT, kInt4, 256>(p, st);
}

}  // namespace

// q [b, sq, h, dh] (q_dtype 0 = f32, 1 = bf16; out has q's dtype);
// pages [n_pages, ps, kvh, dh] (kv_dtype 0 = f32, 1 = bf16, 2 = int8 with
// f32 scales [n_pages, ps, kvh, 1]; 3 = int4: int8 [n_pages, ps, kvh, dh/2]
// packed bytes, bf16 scales [n_pages, ps, kvh, 1] and f32 redistribution
// rows k/v_redist [kvh, dh]; pointers a mode does not use are null); table
// [b, n_table] int32; pos [b] int32.  softcap <= 0 means none.  The table
// is cut into n_split splits of pages_per_split pages (the last may be
// shorter, none empty); with n_split > 1, `workspace` holds
// n_split * b * kvh * rows_pad * (dh + 2) floats, rows_pad = sq * h / kvh
// rounded up to 64.  dh <= 256 (even for int4 pages).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_redist,
    const void* v_redist, const void* table, const void* pos, void* out,
    void* workspace, int b, int sq, int h, int kvh, int dh, int ps,
    int n_table, int window, int pages_per_split, int n_split, float scale,
    float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const bool int4 = kv_dtype == 3;
  if (kvh <= 0 || h % kvh != 0 || dh <= 0 || dh > 256 || ps <= 0 ||
      (int4 && dh % 2) || n_table < 0 || pages_per_split < 1 || n_split < 1 ||
      static_cast<long long>(n_split) * pages_per_split <
          static_cast<long long>(n_table) ||
      (n_split - 1) * static_cast<long long>(pages_per_split) >=
          (n_table > 0 ? n_table : 1) ||
      (n_split > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static const int kElem[] = {4, 2, 1};
  if (kv_dtype < 0 || kv_dtype > 3) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k_pages, v_pages, k_scale, v_scale,
           static_cast<const float*>(k_redist), static_cast<const float*>(v_redist),
           static_cast<const int*>(table), static_cast<const int*>(pos), out,
           static_cast<float*>(workspace)};
  p.b = b, p.sq = sq, p.h = h, p.kvh = kvh, p.dh = dh, p.ps = ps;
  p.n_table = n_table, p.window = window, p.pps = pages_per_split;
  p.n_split = n_split;
  const int rows = sq * (h / kvh);
  p.rows_pad = (rows + kRows - 1) / kRows * kRows;
  p.row_bytes = int4 ? dh / 2 : dh * kElem[kv_dtype];
  p.raw_ld = (p.row_bytes + 15) / 16 * 16;
  p.chunk = attn::copy_chunk(p.row_bytes, {k_pages, v_pages});
  p.q_chunk = attn::copy_chunk(dh * (q_dtype == 0 ? 4 : 2), {q});
  p.scale = scale, p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_dh<float, float>(p, st);
    if (kv_dtype == 1) return launch_dh<float, __nv_bfloat16>(p, st);
    if (kv_dtype == 2) return launch_dh<float, int8_t>(p, st);
    return launch_dh<float, int8_t, true>(p, st);
  }
  if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_dh<__nv_bfloat16, float>(p, st);
    if (kv_dtype == 1) return launch_dh<__nv_bfloat16, __nv_bfloat16>(p, st);
    if (kv_dtype == 2) return launch_dh<__nv_bfloat16, int8_t>(p, st);
    return launch_dh<__nv_bfloat16, int8_t, true>(p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
