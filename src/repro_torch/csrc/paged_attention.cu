// Paged attention over a block pool of KV pages (fp, int8 or int4 pages).
//
// Replaces: src/repro/kernels/paged_attention.py `_kernel` /
// `paged_attention_pallas` (Pallas), all three page modes.
//
// Query rows: slot b, KV head hh holds the sq * g rows r = i * g + gg
// (query token i at absolute position pos[b] + i, query head hh * g + gg).
// Grid: (KV split, row tile, slot x KV head).  A block takes one tile of
// up to 64 of those rows (4 warps x 16; a ragged last tile is masked) and
// one split of the slot's page table: pages [split * pps, split * pps +
// pps).  Two tiles of 64 rows, picked by the wrapper from the shape
// (`chunk`):
//   the row tile: the MMA row tile of attention_common.cuh (WarpTile);
//     decode, verify, bf16 q, dh 256;
//   the chunk tile (ChunkTile below): register-blocked fmaf chains on the
//     CUDA cores; f32 q with more than 64 rows per (slot, KV head) (a
//     prefill chunk) and dh <= 128, a multiple of 8.
// Only the table's width n_table is known on the host (pos stays on the
// card: no host sync, and the launch can be captured in a CUDA graph), so the
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
// The chunk tile dequantizes K, takes the scores, then dequantizes V into
// the same tile and takes P.V, so that three of its blocks fit an SM.
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
// sq * g rows reuses each page that many times and is bound by its f32
// operations on the CUDA cores (67 TFLOP/s).
// Design for the bytes and for the SMs: the page codes are what crosses
// device memory, read once per (slot, head, row tile); the KV split gives
// decode b * kvh * splits blocks instead of b * kvh (qwen2: 64 on 8 pages
// of 16 rather than 8).  Design for the operations (the chunk tile): each
// shared-memory load feeds 4 (q, k) or 16 (v) FMAs, 16 or more independent
// chains a thread, and the row tiles with the most keys start first (slots
// by descending position, row tiles from the last), so that the last wave
// holds the lightest tiles.  Three of its blocks (12 warps) share an SM:
// against 128-row tiles of 8 warps, two an SM (16 warps), they were as fast
// at 3 or 5 chunks and 1.3x faster at 1 or 2 (tools/attention_probe.py,
// PERF.md).
//
// Shared memory per block (bytes, kBk = 4096 / kDh, kDh = dh rounded up
// to 64, 128 or 256, kLd = kDh + 4 (f32 q) or kDh + 8 (bf16 q), raw_ld =
// a page row's bytes rounded up to 16, T = the tile's K/V tiles: 2 for the
// row tile, 1 for the chunk tile):
//   sizeof(q) * (64 + T kBk) * kLd    query tile, K and V tiles
//   + 4 kBk raw_ld                    two stages of raw K and V rows
//   + 4 (2 kBk + 2 kDh) + 4 pps       scales, redist rows, page ids
//   (+ 4)                             the chunk tile's slot
// It no longer grows with sq * g: at dh 64, 60 KB for int4 pages under
// f32 q, 118 KB for f32 pages under f32 q; the chunk tile at dh 128 on
// int8 pages about 70 KB.  Above 48 KB the launcher opts in with
// cudaFuncSetAttribute; a refusal is returned as an error.
//
// Left for a wgmma/TMA version: TMA page copies behind mbarriers, a
// producer warp that dequantizes while consumer warps run wgmma, and one
// block serving all row tiles of a (slot, head) to read each page once.
// (f32 q stays on the CUDA cores: tensor-core f32 sums flipped codes
// downstream, PERF.md.)
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

// The chunk tile: 64 query rows under f32 q, 4 warps of 16, register-
// blocked on the CUDA cores.  Lane (rg = lane / 8, kg = lane % 8) of warp
// w holds rows 16 w + rg + 4 i (i < 4): their scores against keys kg + 8 j
// of the key tile (j < kBk / 8; 16 or 32 independent fmaf chains) and
// their output channels 32 n + 4 kg + e (n < kDh / 32, e < 4).  Each q or k
// float4 read from shared memory feeds 4 chains, each v float4 16; the rows
// rg + 4 i and keys kg + 8 j fall in distinct banks of the padded tiles.
//
// The arithmetic is WarpTile's f32 path, operation for operation, so that
// the output is the row tile's bit for bit: a score is one fmaf chain over
// the channels from 0; the max, alpha and p as there; O = O * alpha, then
// fmaf over the tile's keys in order, p shuffled from the lane that holds
// the key.  WarpTile's lane t of a row sums the probabilities of keys with
// key % 8 / 2 = t in tile order (8 j + 2 t, then + 1); here lanes kg = 2 t
// and 2 t + 1 hold those keys, exchange them and both keep that sum, and
// finish() adds the four by the same butterfly ((t0 + t1) + (t2 + t3)).
// `whole` normalizes in PyTorch's warp-softmax order (WarpTile::normalize,
// key L of torch lane L % 32 held by lane kg = L % 8).
template <int kDh>
struct ChunkTile {
  static constexpr int kR = 4;  // rows a lane
  static constexpr int kBk = attn::key_tile<kDh>();
  static constexpr int kJ = kBk / 8;   // keys a lane
  static constexpr int kN = kDh / 32;  // float4s of output channels a lane
  static constexpr int kLd = attn::tile_ld<float, kDh>();
  static_assert(kDh == 64 || kDh == 128, "the chunk tile holds dh <= 128");

  float o[kR][kN][4];
  float m[kR], l[kR];  // l: the lane pair's partial sum until finish()
  bool normalized;     // O holds normalized rows, l = 1

  // the lane's row i within the block's query tile
  static __device__ __forceinline__ int row(int i) {
    return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 3) + 4 * i;
  }

  __device__ __forceinline__ void init(float neg_inf) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
      m[i] = neg_inf;
      l[i] = 0.f;
    }
    normalized = false;
  }

  // Scores of the lane's rows against the key tile ks [kBk][kLd] (qs: the
  // block's query tile) and the online-softmax update; leaves p in s.
  // Keys n_keys.. weigh 0 (a block of 8 past n_keys is not computed into
  // anything).  allow(i, key), `whole`: as WarpTile::consume.
  template <typename Allow>
  __device__ __forceinline__ void scores(const float* qs, const float* ks,
                                         int n_keys, float scale, float softcap,
                                         float neg_inf, Allow allow, bool whole,
                                         float (&s)[kR][kJ]) {
    const int kg = threadIdx.x & 7;
    const float* q0 = qs + row(0) * kLd;
    const float* k0 = ks + kg * kLd;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      float4 qv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q0 + 4 * i * kLd + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(k0 + 8 * j * kLd + d);
#pragma unroll
        for (int i = 0; i < kR; ++i)
          s[i][j] = fmaf(qv[i].w, x.w,
                         fmaf(qv[i].z, x.z, fmaf(qv[i].y, x.y, fmaf(qv[i].x, x.x, s[i][j]))));
      }
    }

    float mx[kR], alpha[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      mx[i] = m[i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int key = kg + 8 * j;
        float v = s[i][j] * scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        v = key < n_keys ? (allow(i, key) ? v : neg_inf) : -INFINITY;
        s[i][j] = v;
        mx[i] = fmaxf(mx[i], v);
      }
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    const bool odd = kg & 1;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j * 8 < n_keys) {
          const float p = expf(s[i][j] - mx[i]);
          const float other = __shfl_xor_sync(0xffffffffu, p, 1);
          s[i][j] = p;
          psum += odd ? other : p;  // key 8 j + 2 t, then 8 j + 2 t + 1
          psum += odd ? p : other;
        } else {  // no key in this block: weight 0, as exp(-inf) gives
          s[i][j] = 0.f;
        }
      }
      l[i] = l[i] * alpha[i] + psum;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] *= alpha[i];
    }
    if (whole) normalize(s);
  }

  // O += P.V over the key tile vs [kBk][kLd] (rows n_keys.. up to the next
  // multiple of 16 are zero), one key after the other
  __device__ __forceinline__ void accumulate(const float (&p)[kR][kJ],
                                             const float* vs, int n_keys) {
    const int lane = threadIdx.x & 31, src = lane & ~7;
    const float* v0 = vs + 4 * (lane & 7);
#pragma unroll 1
    for (int kk = 0; kk < kJ && kk * 8 < n_keys; ++kk) {
      float pk[kR];  // this lane's p of key kk * 8 + kg
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        pk[i] = p[i][0];
#pragma unroll
        for (int j = 1; j < kJ; ++j) pk[i] = kk == j ? p[i][j] : pk[i];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float pv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) pv[i] = __shfl_sync(0xffffffffu, pk[i], src | c);
        const float* vr = v0 + (kk * 8 + c) * kLd;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float4 v = *reinterpret_cast<const float4*>(vr + 32 * n);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            o[i][n][0] = fmaf(pv[i], v.x, o[i][n][0]);
            o[i][n][1] = fmaf(pv[i], v.y, o[i][n][1]);
            o[i][n][2] = fmaf(pv[i], v.z, o[i][n][2]);
            o[i][n][3] = fmaf(pv[i], v.w, o[i][n][3]);
          }
        }
      }
    }
  }

  // the denominators summed over the four lane pairs of each row
  __device__ __forceinline__ void finish() {
    if (normalized) return;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    }
  }

  // visit(i, d, value) for the lane's rows i < kR and its channels d
  template <typename Visit>
  __device__ __forceinline__ void for_each(Visit visit) const {
    const int kg = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) visit(i, 32 * n + 4 * kg + e, o[i][n][e]);
  }

 private:
  // p -> p / L for the whole row, L summed as PyTorch's warp softmax does:
  // torch lane L' (of 32) adds keys L', L' + 32 in order, then an xor
  // butterfly over the lanes with offsets 16, 8, 4, 2, 1.  Keys kg + 8 a
  // and + 32 are this lane's p[a] and p[a + 4], so the offsets 16 and 8 are
  // lane-local and 4, 2, 1 are lane xors.  Keys past the tile are zeros.
  __device__ __forceinline__ void normalize(float (&p)[kR][kJ]) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float tl[4];  // torch lanes kg + 8 a
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e0 = a < kJ ? p[i][a] : 0.f;
        const float e1 = a + 4 < kJ ? p[i][a + 4] : 0.f;
        tl[a] = e0 + e1;
      }
      float v = (tl[0] + tl[2]) + (tl[1] + tl[3]);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
#pragma unroll
      for (int j = 0; j < kJ; ++j) p[i][j] = __fdiv_rn(p[i][j], v);
      l[i] = 1.f;
    }
    normalized = true;
  }
};

template <typename QT, int kDh, bool kChunk>
struct TileOf {
  using type = attn::WarpTile<QT, kDh, true>;
};
template <typename QT, int kDh>
struct TileOf<QT, kDh, true> {
  using type = ChunkTile<kDh>;
};

// The chunk tile's work order: the item of this block, heaviest first.
// Slots by descending position (ties: the lower index first), then row
// tiles from the last (the most keys under the causal mask), KV heads
// fastest.  The hardware starts blocks in the order of their index.
__device__ __forceinline__ void heaviest_first(const Params& p, int* slot_s,
                                               int& b, int& hh, int& rt) {
  const int n_rt = gridDim.y, item = blockIdx.y + n_rt * blockIdx.z;
  hh = item % p.kvh;
  const int rest = item / p.kvh;
  rt = n_rt - 1 - rest % n_rt;
  const int rank = rest / n_rt;
  for (int s = threadIdx.x; s < p.b; s += blockDim.x) {
    const int mine = p.pos[s];
    int above = 0;
    for (int s2 = 0; s2 < p.b; ++s2) {
      const int other = p.pos[s2];
      above += other > mine || (other == mine && s2 < s);
    }
    if (above == rank) *slot_s = s;
  }
  __syncthreads();
  b = *slot_s;
}

// three blocks of the chunk tile an SM (at most 170 registers a thread)
template <typename QT, typename KT, bool kInt4, int kDh, bool kChunk = false>
__global__ void __launch_bounds__(kThreads, kChunk ? 3 : 1)
    paged_attention_kernel(const Params p) {
  using Tile = typename TileOf<QT, kDh, kChunk>::type;
  constexpr int kR = std::extent<decltype(Tile::m)>::value;  // rows a lane
  constexpr int kBk = attn::key_tile<kDh>();
  constexpr int kLd = attn::tile_ld<QT, kDh>();
  constexpr int kKvTiles = kChunk ? 1 : 2;
  constexpr bool kScaled = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QT* qs = reinterpret_cast<QT*>(smem_raw);  // [kRows][kLd]
  QT* ks = qs + kRows * kLd;                  // [kBk][kLd]
  QT* vs = ks + (kKvTiles - 1) * kBk * kLd;   // [kBk][kLd] (the chunk tile: ks)
  unsigned char* raw =
      reinterpret_cast<unsigned char*>(vs + kBk * kLd);  // [2][K, V][kBk][raw_ld]
  float* sc = reinterpret_cast<float*>(raw + 4 * kBk * p.raw_ld);  // [K, V][kBk]
  float* red = sc + 2 * kBk;                          // [K, V][kDh]
  int* ids = reinterpret_cast<int*>(red + 2 * kDh);  // [pps] (+ the chunk tile's slot)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int sp = blockIdx.x;
  int b = blockIdx.z / p.kvh, hh = blockIdx.z % p.kvh, rt = blockIdx.y;
  if constexpr (kChunk) heaviest_first(p, ids + p.pps, b, hh, rt);
  const int z = b * p.kvh + hh;
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
    for (int idx = tid; idx < (kRows + kKvTiles * kBk) * kDh; idx += kThreads)
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
                      static_cast<size_t>(z) * p.rows_pad + r_begin;
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

  Tile st;
  st.init(kNegInf);
  int qpos[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) qpos[i] = p0 + (r_begin + Tile::row(i)) / g;

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
    if constexpr (kChunk) {
      // one K/V tile: K, the scores, then V and P.V.  Four channels a
      // thread (one 32-bit load of int8 or int4 codes, one float4 store;
      // dh % 8 == 0), each as the row tile's loop computes it.
      const auto dequant = [&](QT* dst, const unsigned char* src, const float* scl,
                               const float* rd) {
        constexpr int kQuads = kDh / 4;
        const int half = dh >> 1;
#pragma unroll 1  // the registers of O and P are live around it
        for (int idx = tid; idx < n_rows * kQuads; idx += kThreads) {
          const int kk = idx / kQuads, d = idx % kQuads * 4;
          if (d >= dh) continue;
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          if (kk < nk) {
            const unsigned char* r = src + kk * p.raw_ld;
            if constexpr (kScaled) {
              const uint32_t w = *reinterpret_cast<const uint32_t*>(
                  r + (kInt4 && d >= half ? d - half : d));
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = static_cast<int8_t>(w >> (8 * e));  // sign-extended
                if constexpr (kInt4) {
                  const unsigned u = static_cast<unsigned>(c);
                  x[e] = __fmul_rn(
                      __fmul_rn(static_cast<float>(
                                    static_cast<int>(u << (d < half ? 28 : 24)) >> 28),
                                scl[kk]),
                      rd[d + e]);
                } else {
                  x[e] = __fmul_rn(static_cast<float>(c), scl[kk]);
                }
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) x[e] = to_float(reinterpret_cast<const KT*>(r)[d + e]);
            }
          }
          *reinterpret_cast<float4*>(dst + kk * kLd + d) = float4{x[0], x[1], x[2], x[3]};
        }
      };
      // every row of the block may attend every key of this tile: no mask
      const bool open = t0 + nk - 1 <= p0 + r_begin / g &&
                        t0 > p0 + (r_begin + rows_t - 1) / g - p.window;
      float s[kR][Tile::kJ];
      dequant(ks, rk, sc, red);
      __syncthreads();
      if (warp * 16 < rows_t)
        st.scores(qs, ks, nk, p.scale, p.softcap, kNegInf,
                  [&](int i, int key) {
                    // the row's position, here rather than held in registers
                    const int qp = p0 + (r_begin + Tile::row(i)) / g, kpos = t0 + key;
                    return open || (kpos <= qp && kpos > qp - p.window);
                  },
                  p.n_split == 1 && n_tiles == 1, s);
      __syncthreads();  // every warp is done with K
      dequant(vs, rv, sc + kBk, red + kDh);
      __syncthreads();
      if (warp * 16 < rows_t) st.accumulate(s, vs, nk);
    } else {
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
  }
  if (n_tiles == 0) {
    ptx::cp_async_wait<0>();
    __syncthreads();
  }

  if (warp * 16 >= rows_t) return;
  st.finish();
  // the lane that writes its rows' m and l
  const bool owner = (tid & (kChunk ? 7 : 3)) == 0;
  if (p.n_split == 1) {
    QT* out = static_cast<QT*>(p.out);
    st.for_each([&](int i, int d, float v) {
      const int r = Tile::row(i), R = r_begin + r;
      if (r < rows_t && d < dh) {
        const int qi = R / g, gg = R % g;
        attn::store(out + ((static_cast<size_t>(b) * p.sq + qi) * p.h + hh * g + gg) *
                              dh + d,
                    v / fmaxf(st.l[i], 1e-30f));
      }
    });
  } else {
    st.for_each([&](int i, int d, float v) {
      const int r = Tile::row(i);
      if (r < rows_t && d < dh) p.ws[(row0 + r) * dh + d] = v;
    });
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = Tile::row(i);
      if (owner && r < rows_t) {
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

template <typename QT, typename KT, bool kInt4, int kDh, bool kChunk = false>
int launch(const Params& p, cudaStream_t st) {
  constexpr int kBk = attn::key_tile<kDh>();
  constexpr int kLd = attn::tile_ld<QT, kDh>();
  const int rows = p.sq * (p.h / p.kvh);
  const size_t smem = sizeof(QT) * (kRows + (kChunk ? 1 : 2) * kBk) * kLd +
                      4 * static_cast<size_t>(kBk) * p.raw_ld +
                      sizeof(float) * (2 * kBk + 2 * kDh) +
                      sizeof(int) * (static_cast<size_t>(p.pps) + kChunk);
  static size_t opted_in = 48 * 1024;
  const int rc = attn::launch_kernel(
      paged_attention_kernel<QT, KT, kInt4, kDh, kChunk>, &opted_in,
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

// the chunk tile (f32 q, dh <= 128)
template <typename KT, bool kInt4 = false>
int launch_chunk(const Params& p, cudaStream_t st) {
  if (p.dh <= 64) return launch<float, KT, kInt4, 64, true>(p, st);
  return launch<float, KT, kInt4, 128, true>(p, st);
}

}  // namespace

// q [b, sq, h, dh] (q_dtype 0 = f32, 1 = bf16; out has q's dtype);
// pages [n_pages, ps, kvh, dh] (kv_dtype 0 = f32, 1 = bf16, 2 = int8 with
// f32 scales [n_pages, ps, kvh, 1]; 3 = int4: int8 [n_pages, ps, kvh, dh/2]
// packed bytes, bf16 scales [n_pages, ps, kvh, 1] and f32 redistribution
// rows k/v_redist [kvh, dh]; pointers a mode does not use are null); table
// [b, n_table] int32; pos [b] int32.  softcap <= 0 means none.  The table
// is cut into n_split splits of pages_per_split pages (the last may be
// shorter, none empty); chunk 1 takes the chunk tile (f32 q, dh <= 128, dh
// % 8 == 0), 0 the row tile.  With n_split > 1, `workspace` holds n_split * b * kvh *
// rows_pad * (dh + 2) floats, rows_pad = sq * h / kvh rounded up to 64.
// dh <= 256 (even for int4 pages).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_redist,
    const void* v_redist, const void* table, const void* pos, void* out,
    void* workspace, int b, int sq, int h, int kvh, int dh, int ps,
    int n_table, int window, int pages_per_split, int n_split, int chunk,
    float scale, float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const bool int4 = kv_dtype == 3;
  if (kvh <= 0 || h % kvh != 0 || dh <= 0 || dh > 256 || ps <= 0 ||
      (int4 && dh % 2) || n_table < 0 || pages_per_split < 1 || n_split < 1 ||
      static_cast<long long>(n_split) * pages_per_split <
          static_cast<long long>(n_table) ||
      (n_split - 1) * static_cast<long long>(pages_per_split) >=
          (n_table > 0 ? n_table : 1) ||
      (n_split > 1 && workspace == nullptr) ||
      (chunk != 0 && !(chunk == 1 && q_dtype == 0 && dh <= 128 && dh % 8 == 0)))
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
  if (chunk) {
    if (kv_dtype == 0) return launch_chunk<float>(p, st);
    if (kv_dtype == 1) return launch_chunk<__nv_bfloat16>(p, st);
    if (kv_dtype == 2) return launch_chunk<int8_t>(p, st);
    return launch_chunk<int8_t, true>(p, st);
  }
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
