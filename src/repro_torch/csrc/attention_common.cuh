// The attention core shared by paged_attention.cu and flash_attention.cu:
// an online-softmax update of a block's query rows by one key tile in
// shared memory, in the FlashAttention-2 register layout (tensor cores for
// bf16, CUDA-core FMAs for f32), plus dtype helpers, asynchronous row
// copies and the launch with a shared-memory opt-in.
//
// A block is kWarps = 4 warps and holds a tile of kRows = 64 query rows;
// warp w owns rows 16w..16w+15.  Per key tile (kBk keys, see key_tile) a
// warp computes its scores S = Q.K^T and its update O += P.V, and keeps
// its running max m, denominator l and un-normalized output O in
// registers: lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of
// the warp and, for each 8-wide block of keys or channels, the two columns
// 2t and 2t + 1 (the layout of an mma.sync accumulator).  Row maxima and,
// at the end, the denominators are reduced over the four lanes of a row.
//
// The core is templated on q's dtype, which is also the element type of
// the shared-memory tiles:
//   bf16: S with mma m16n8k16 bf16 (products exact in f32, f32
//         accumulation).  P is split into a bf16 high part and a bf16
//         remainder, and O += P_hi.V + P_lo.V (about 16 bits of P, where
//         the reference keeps P in f32).  V fragments come transposed
//         through ldmatrix.  The tensor cores truncate their sums; that
//         drift stays far below the output's bf16 rounding.
//   f32:  FMAs on the CUDA cores, in the same register layout: a score is
//         one fmaf chain over the head dim from 0, in channel order, as
//         the plain version's product forms it; O += p v one key after the
//         other.  3xTF32 on the tensor cores (each operand split into a
//         tf32 head and remainder, three MMAs a product) met the f32
//         checks, but its truncated sums left it twice as far from the
//         plain version as these chains, and that distance flipped int4
//         and int8 codes in the in-situ checks (PERF.md).  A tile that
//         holds every key of its rows is normalized before P.V the way the
//         plain version is (`whole`, normalize): its output is then the
//         plain version's, bit for bit.
// Order of operations per key tile, as in the reference: s = dot * scale,
// then the softcap, then the mask (a masked key scores `neg_inf`, finite; a
// key past the tile's end scores -inf and weighs exactly 0), then
// m_new = max(m, max s), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + sum p, O = O * alpha + P.V.  m starts at neg_inf, so it is
// always finite and no exp(-inf - -inf) arises; the output is O / max(l,
// 1e-30).  A row all of whose keys are masked averages V over the keys
// read, as before.
//
// Shared memory per block: the query tile [kRows][kLd] and each K or V
// tile [kBk][kLd] of q's dtype, rows padded (kLd = kDh + 4 floats or
// kDh + 8 bf16) so that the fragment loads are free of bank conflicts;
// channels dh..kDh are zero.  Each kernel stages its own K/V tiles and
// mask; see the kernels for their totals.
//
// Left for a wgmma/TMA version: warpgroup MMA from shared memory (no
// fragment loads through registers), TMA tile copies with mbarriers in
// place of cp.async, and a producer warp feeding consumer warpgroups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "launch.cuh"
#include "ptx.cuh"

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block's tile

// keys of a K/V tile: 64 up to head dim 64, 32 up to 128, 16 up to 256
template <int kDh>
__host__ __device__ constexpr int key_tile() {
  return 4096 / kDh;
}
// row stride, in elements, of a shared-memory tile of q's dtype QT
template <typename QT, int kDh>
__host__ __device__ constexpr int tile_ld() {
  return kDh + (sizeof(QT) == 4 ? 4 : 8);
}

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&a)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&b)) << 16);
}
// (x0, x1) -> bf16 pairs hi = (bf16(x0), bf16(x1)) and lo = the remainders
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One warp's 16 query rows: online-softmax state in registers.  kCompact
// keeps the f32 loops rolled: a paged block at decode runs its code once,
// and unrolled code (hundreds of KB) would be fetched from L2 instruction
// by instruction; flash runs the same code over many tiles and unrolls.
template <typename QT, int kDh, bool kCompact = false>
struct WarpTile {
  static constexpr int kBk = key_tile<kDh>();
  static constexpr int kLd = tile_ld<QT, kDh>();
  static constexpr bool kF32 = std::is_same<QT, float>::value;
  static_assert(kDh % 64 == 0 && kBk % 16 == 0, "tile shape");

  float o[kDh / 8][4];  // O: rows g, g + 8 x channels 8 dn + 2t, + 1
  float m[2], l[2];     // rows g and g + 8 (l: this lane's partial sum)
  bool normalized;      // O holds normalized rows, l = 1 (see consume)

  // the lane's row i (0 or 1) within the block's query tile
  static __device__ __forceinline__ int row(int i) {
    return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * i;
  }

  __device__ __forceinline__ void init(float neg_inf) {
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    m[0] = m[1] = neg_inf;
    l[0] = l[1] = 0.f;
    normalized = false;
  }

  // Consume one key tile.  qs: the warp's 16 query rows [16][kLd]; ks, vs:
  // the tile [kBk][kLd] (rows n_keys.. of vs, up to the next multiple of 16,
  // are zero); channels dh..kDh of all three are zero, and every product
  // runs over kDh.  allow(i, key): may the lane's row i attend the tile's
  // key?  `whole` (f32 only): this tile holds every key of its rows, the
  // first and only tile; the probabilities are then normalized before P.V,
  // with the row's true max and its sum taken in the order of PyTorch's
  // warp softmax, so that the result is the plain version's own arithmetic
  // (its products are the same sequential fmaf chains).
  template <typename Allow>
  __device__ __forceinline__ void consume(const QT* qs, const QT* ks,
                                          const QT* vs, int n_keys,
                                          float scale, float softcap,
                                          float neg_inf, Allow allow,
                                          bool whole = false) {
    float s[kBk / 8][4];
    scores(qs, ks, n_keys, s);
    softmax(s, n_keys, scale, softcap, neg_inf, allow);
    if constexpr (kF32) {
      if (whole) normalize(s);
    }
    accumulate(s, vs, n_keys);
  }

  // the denominators summed over the four lanes of each row
  __device__ __forceinline__ void finish() {
    if (normalized) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }

  // visit(i, d, value) for the lane's rows i = 0, 1 and its channels d
  // (all kDh of them; the caller drops d >= dh and rows past its tile)
  template <typename Visit>
  __device__ __forceinline__ void for_each(Visit visit) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        visit(e >> 1, dn * 8 + 2 * t + (e & 1), o[dn][e]);
  }

 private:
  __device__ __forceinline__ void scores(const QT* qs, const QT* ks,
                                         int n_keys, float (&s)[kBk / 8][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kF32) {
      // rows g, g + 8 against keys 8j + 2t, + 1: one fmaf chain over the
      // channels in order (channels past dh are zero in both tiles, so the
      // chain over kDh adds exact zeros)
      const float* q0 = qs + g * kLd;
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        if (j * 8 < n_keys) {
          const float* k0 = ks + (j * 8 + 2 * t) * kLd;
          float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll(kCompact ? 2 : kDh / 4)
          for (int d = 0; d < kDh; d += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(q0 + d);
            const float4 qb = *reinterpret_cast<const float4*>(q0 + 8 * kLd + d);
            const float4 x = *reinterpret_cast<const float4*>(k0 + d);
            const float4 y = *reinterpret_cast<const float4*>(k0 + kLd + d);
            a0 = fmaf(qa.w, x.w, fmaf(qa.z, x.z, fmaf(qa.y, x.y, fmaf(qa.x, x.x, a0))));
            a1 = fmaf(qa.w, y.w, fmaf(qa.z, y.z, fmaf(qa.y, y.y, fmaf(qa.x, y.x, a1))));
            b0 = fmaf(qb.w, x.w, fmaf(qb.z, x.z, fmaf(qb.y, x.y, fmaf(qb.x, x.x, b0))));
            b1 = fmaf(qb.w, y.w, fmaf(qb.z, y.z, fmaf(qb.y, y.y, fmaf(qb.x, y.x, b1))));
          }
          s[j][0] = a0;
          s[j][1] = a1;
          s[j][2] = b0;
          s[j][3] = b1;
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < kDh / 16; ++kc) {
        const QT* q0 = qs + g * kLd + kc * 16 + 2 * t;
        const uint32_t a[4] = {ld32(q0), ld32(q0 + 8 * kLd), ld32(q0 + 8),
                               ld32(q0 + 8 * kLd + 8)};
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j) {
          if (j * 8 < n_keys) {
            const QT* k0 = ks + (j * 8 + g) * kLd + kc * 16 + 2 * t;
            ptx::mma_bf16(s[j], a, ld32(k0), ld32(k0 + 8));
          }
        }
      }
    }
  }

  template <typename Allow>
  __device__ __forceinline__ void softmax(float (&s)[kBk / 8][4], int n_keys,
                                          float scale, float softcap,
                                          float neg_inf, Allow allow) {
    const int t = threadIdx.x & 3;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        float v = s[j][e] * scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        v = key < n_keys ? (allow(e >> 1, key) ? v : neg_inf) : -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      if (j * 8 < n_keys) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - mx[e >> 1]);
          s[j][e] = p;
          psum[e >> 1] += p;
        }
      } else {  // no key in this block: weight 0, as exp(-inf) gives
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];
  }

  // p -> p / L for the whole row.  PyTorch's warp softmax sums a row as:
  // lane l (of 32) adds keys l, l + 32, ... in order, then an xor butterfly
  // over the lanes with offsets 16, 8, 4, 2, 1.  Key 8a + 2t + c + 32w sits
  // in this lane (column c) as p[a + 4w][2i + c], so the per-lane sums and
  // the offsets 16 and 8 are lane-local, 4 and 2 are xor 2 and 1 within the
  // quad, and 1 is the two columns.  Keys past the tile are zeros there.
  __device__ __forceinline__ void normalize(float (&p)[kBk / 8][4]) {
    constexpr int kJ = kBk / 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float u[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float tl[2];  // torch lanes 8a + 2t + c and that + 16
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = a + 2 * h;
            const float e0 = j < kJ ? p[j][2 * i + c] : 0.f;
            const float e1 = j + 4 < kJ ? p[j + 4][2 * i + c] : 0.f;
            tl[h] = e0 + e1;
          }
          u[a] = tl[0] + tl[1];
        }
        v[c] = u[0] + u[1];
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], 2);
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], 1);
      }
      const float sum = v[0] + v[1];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          p[j][2 * i + c] = __fdiv_rn(p[j][2 * i + c], sum);
      l[i] = 1.f;
    }
    normalized = true;
  }

  __device__ __forceinline__ void accumulate(const float (&p)[kBk / 8][4],
                                             const QT* vs, int n_keys) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    if constexpr (kF32) {
      // O += p v, one key after the other: key c of an 8-key block is
      // lane t = c / 2's column c % 2 in the row's quad
#pragma unroll
      for (int kk = 0; kk < kBk / 8; ++kk) {
        if (kk * 8 < n_keys) {
#pragma unroll(kCompact ? 1 : 8)
          for (int c = 0; c < 8; ++c) {
            const int src = (lane & ~3) | (c >> 1);
            const float p0 = __shfl_sync(0xffffffffu, c & 1 ? p[kk][1] : p[kk][0], src);
            const float p1 = __shfl_sync(0xffffffffu, c & 1 ? p[kk][3] : p[kk][2], src);
            const float* vr = vs + (kk * 8 + c) * kLd + 2 * t;
#pragma unroll
            for (int dn = 0; dn < kDh / 8; ++dn) {
              const float2 v = *reinterpret_cast<const float2*>(vr + dn * 8);
              o[dn][0] = fmaf(p0, v.x, o[dn][0]);
              o[dn][1] = fmaf(p0, v.y, o[dn][1]);
              o[dn][2] = fmaf(p1, v.x, o[dn][2]);
              o[dn][3] = fmaf(p1, v.y, o[dn][3]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        if (kk * 16 < n_keys) {
          uint32_t ah[4], al[4];
          split_bf16(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
          split_bf16(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
          split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
          split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
          // matrix lane / 8: keys + 8 (lane / 8 % 2), channels + 8 (lane / 16)
          const QT* vrow =
              vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
              (lane >> 4) * 8;
#pragma unroll
          for (int dn = 0; dn < kDh / 16; ++dn) {
            uint32_t b[4];
            ptx::ldmatrix_x4_trans(b, vrow + dn * 16);
            ptx::mma_bf16(o[2 * dn], al, b[0], b[1]);
            ptx::mma_bf16(o[2 * dn], ah, b[0], b[1]);
            ptx::mma_bf16(o[2 * dn + 1], al, b[2], b[3]);
            ptx::mma_bf16(o[2 * dn + 1], ah, b[2], b[3]);
          }
        }
      }
    }
  }
};

// Largest cp.async size (16, 8 or 4 bytes) that divides a row of `bytes`
// and the alignment of every base address; 0: copy with plain loads.
inline int copy_chunk(int bytes, std::initializer_list<const void*> bases) {
  uintptr_t align = static_cast<uintptr_t>(bytes);
  for (const void* b : bases) align |= reinterpret_cast<uintptr_t>(b);
  for (int c = 16; c >= 4; c >>= 1)
    if (align % c == 0) return c;
  return 0;
}

// Copy `bytes` (a multiple of chunk) from global to shared memory with
// cp.async of `chunk` bytes, piece `c` of them; chunk 0: plain byte loads.
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src, int chunk,
                                           int c) {
  if (chunk == 16) {
    ptx::cp_async<16>(dst + 16 * c, src + 16 * c);
  } else if (chunk == 8) {
    ptx::cp_async<8>(dst + 8 * c, src + 8 * c);
  } else if (chunk == 4) {
    ptx::cp_async<4>(dst + 4 * c, src + 4 * c);
  } else {
    dst[c] = src[c];
  }
}

// Stage `n` rows of `bytes` each into shared memory (row r at dst + r *
// dst_ld bytes) from src(r), with cp.async of `chunk` bytes (0: plain
// loads); every thread of the block takes its share.
template <typename Src>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_ld,
                                          int n, int bytes, int chunk,
                                          Src src) {
  const int pieces = chunk ? bytes / chunk : bytes;
  for (int idx = threadIdx.x; idx < n * pieces; idx += blockDim.x) {
    const int r = idx / pieces;
    copy_piece(dst + r * dst_ld, src(r), chunk, idx % pieces);
  }
}

using klaunch::launch_kernel;
using klaunch::opt_in;

}  // namespace attn
