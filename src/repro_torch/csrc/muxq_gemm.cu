// Fused MUXQ int8 GEMM with per-K-block power-of-two scales (paper Eq. 7):
//
//   Y = (sum_kb block_scale[kb] * X[:, kb] @ W[kb, :]) * sx * sw
//
// Replaces: src/repro/kernels/muxq_gemm.py `_kernel` / `muxq_gemm` (Pallas).
//
// Bound on an H100: at every serving M (decode 1-8 rows a slot batch,
// verify 20, prefill 64 or 128: 4 slots x a chunk of 16 or 32) the kernel must read the K*N weight bytes once
// for 2*M operations per byte, far below the int8 tensor cores' balance
// point (~590 operations a byte), so it is a weight stream: gpt2's
// mlp_up (K_pad 1536, N 3072) is 4.7 MB, 1.4 us at 3.35 TB/s; qwen2's
// (N 9728) 14.9 MB, 4.5 us.
//
// Design (what meets that bound):
// - The weight arrives k-major, W^T [N, K] (the served copy is stored so;
//   see kernels/muxq_gemm.py).  X [M, K] is k-major too, so both operands
//   of int8 mma.sync m16n8k32 (which takes k-major A and B only) load
//   without a transpose.  The product runs swapped: W^T rows (output
//   columns) are the MMA's 16 A rows and token rows its 8 B columns, so a
//   decode batch of 4 rows wastes half of an n8 tile, not 12 of 16 rows.
// - Each thread copies 16 contiguous bytes of a row with cp.async and
//   feeds them to two MMA steps as one k-permutation: bytes 0-7 are the
//   first step's k slots 4t..4t+3 and 16+4t..16+4t+3, bytes 8-15 the
//   second's.  A and B use the same permutation, and a dot product does
//   not depend on the order of its k terms, so the result is the plain
//   product's.  Each 16-byte shared load then is a whole fragment, and
//   the weight bytes a thread copies are the ones it reads back.
// - Split-K in a thread block cluster: the K tiles (64 wide) of an
//   output tile are divided among the gridDim.y <= 8 blocks of one
//   cluster until the grid covers the card (the plan below).  Int32
//   sums are exact, and with wrapping adds equal to the plain version's
//   int64 sum cast to int32 in any order, so a split may start and end
//   anywhere: a tile's partial sum is multiplied by its K-block's 2^e when
//   the block (bk wide) ends or the split does.
// - One launch, no global workspace: each block leaves its int32 partial
//   tile in its shared memory; after a cluster barrier, each block sums
//   its share of the tile's elements over the cluster's blocks (16-byte
//   reads of distributed shared memory, in rank order), dequantizes
//   (acc * sx[m] * sw[n], in that order, as the plain version does) and
//   writes them; a second barrier keeps every block's shared memory alive
//   until all have read it.  Nothing is left behind for the next launch.
//   (Pushing each sum into its owner's shared memory with remote atomic
//   adds instead took 32 us at M = 64: tools/gemm_probe.py timeline.)
// - A ring of kStages stages in shared memory keeps kStages - 1 stages in
//   flight per block.  At decode (M <= 8, one n8 tile of rows) a stage
//   holds kDecodeStage = 4 K tiles: each W^T row's 256 contiguous bytes
//   (one 64-byte tile a stage took 18-27 % longer on qwen2's mlp_down and
//   mlp_up); above 8 rows kStage = 2 tiles, a whole 128-byte line of each
//   row (one tile took 1-16 % longer at M 64-128, four up to 1.7x as
//   long: tools/gemm_probe.py variants).  The X tile of the
//   block's rows rides in the same cp.async group as the weight tile, so X
//   costs no round trip of its own.
// - The plan (muxq_gemm_plan below) is the C entry's own: K is split,
//   evenly and into whole stages, until the grid holds kBlocksPerSm blocks
//   a SM (2 or 4 won at a few shapes and lost at others:
//   tools/gemm_probe.py variants).
// Ragged M and N: rows past M and columns past N read row M-1 / N-1 and
// are never stored.  Built without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTileK = 64;              // K bytes a tile (two MMA steps)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockN = 16 * kWarps;    // output columns a block
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;           // blocks in a cluster (portable)
constexpr int kMaxRows = 64;            // token rows a block, at most (8 n8 tiles)
constexpr int kDecodeStage = 4;         // K tiles a stage at 8 rows a block
constexpr int kStage = 2;               // K tiles a stage above 8 rows
constexpr int kBlocksPerSm = 1;         // the grid the split plan aims at

__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// J n8 tiles of token rows (8 J rows) per block; a stage holds S 64-wide
// K tiles (a row's 64 S bytes, contiguous in memory).  Where the split's K
// range ends inside its last stage, that stage's remaining tiles are zero
// bytes (cp.async zero fill, nothing read), so they add nothing and the K
// loop needs no exit of its own (the zero fill costs 0-5 % against plain
// copies at the served shapes, whose stages are never short:
// tools/gemm_probe.py variants)
template <int J, int S>
__global__ void __launch_bounds__(kThreads) muxq_gemm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
    const int* __restrict__ block_scale, const float* __restrict__ sx,
    const float* __restrict__ sw, float* __restrict__ out, int M, int N,
    int K, int bk_tiles, int split_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = 8 * J;
  constexpr int kRow = S * kTileK;                      // bytes a row a stage
  constexpr int kStageBytes = (kBlockN + kRows) * kRow;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN, m0 = blockIdx.z * kRows;
  const int n_splits = gridDim.y;
  const int kt0 = blockIdx.y * split_tiles;             // in 64-wide tiles
  const int kt_end = min(kt0 + split_tiles, K / kTileK);
  const int nt = (kt_end - kt0 + S - 1) / S;            // stages
  // a row's 64-byte piece p sits at slot p ^ (row & 1) of its stage row, so
  // that rows r and r + 1 of one warp's quarter fall in other banks
  auto at = [](int row, int piece) {
    return row * kRow + (S > 1 ? piece ^ (row & 1) : piece) * kTileK;
  };

  auto load = [&](int stage, int ks) {  // stage ks (S tiles) of the split
    unsigned char* st = smem_raw + stage * kStageBytes;
    const size_t k = static_cast<size_t>(kt0 + ks * S) * kTileK;
    const int tiles = min(S, kt_end - kt0 - ks * S);   // past them: zeros
    for (int c = tid; c < kBlockN * S * 4; c += kThreads) {
      const int r = c / (S * 4), p = c / 4 % S, col = 16 * (c & 3);
      ptx::cp_async_zfill16(st + at(r, p) + col,
                            wt + static_cast<size_t>(min(n0 + r, N - 1)) * K + k +
                                min(p, tiles - 1) * kTileK + col,
                            p < tiles);
    }
    unsigned char* xs = st + kBlockN * kRow;
    for (int c = tid; c < kRows * S * 4; c += kThreads) {
      const int r = c / (S * 4), p = c / 4 % S, col = 16 * (c & 3);
      ptx::cp_async_zfill16(xs + at(r, p) + col,
                            x + static_cast<size_t>(min(m0 + r, M - 1)) * K + k +
                                min(p, tiles - 1) * kTileK + col,
                            p < tiles);
    }
  };

  // this thread's W^T rows: output columns n0 + wrow and n0 + wrow + 8
  const int wrow = 16 * warp + g;
  // with splits, each block leaves its partial tile [rows][64 columns] in
  // its ring and then sums, over the cluster's blocks, its share of the
  // tile: runs of 4 columns (a 16-byte read of each block's partial), the
  // q-th of them at q = rank + n_splits * i
  constexpr int kQuads = kRows * kBlockN / 4;
  const int rank = n_splits > 1 ? static_cast<int>(ptx::cluster_rank()) : 0;
  // the scales of this thread's outputs load while the weights stream in:
  // with one split its fragment's rows and columns, else those of its
  // runs, at most kBatch of them with two or more splits (rows past M and
  // columns past N read the last one and are never stored)
  constexpr int kBatch = (kQuads / 2 + kThreads - 1) / kThreads;
  float fx[J][2], fw[2], bx[kBatch], bw[kBatch][4];
  if (n_splits == 1) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) fx[j][c] = sx[min(m0 + 8 * j + 2 * t + c, M - 1)];
#pragma unroll
    for (int h = 0; h < 2; ++h) fw[h] = sw[min(n0 + wrow + 8 * h, N - 1)];
  } else {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = rank + n_splits * (tid + b * kThreads);
      bx[b] = sx[min(m0 + 4 * q / kBlockN, M - 1)];
#pragma unroll
      for (int c = 0; c < 4; ++c) bw[b][c] = sw[min(n0 + 4 * q % kBlockN + c, N - 1)];
    }
  }

  int acc[J][4], part[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s, s);
    ptx::cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();  // every thread's copies of this stage have landed, and
                      // every thread is done with the stage refilled next
    if (it + kStages - 1 < nt) load((it + kStages - 1) % kStages, it + kStages - 1);
    ptx::cp_async_commit();
    const unsigned char* st = smem_raw + (it % kStages) * kStageBytes;
    const unsigned char* xs = st + kBlockN * kRow;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const int kt = kt0 + it * S + p;
      const uint4 lo = *reinterpret_cast<const uint4*>(st + at(wrow, p) + 16 * t);
      const uint4 hi = *reinterpret_cast<const uint4*>(st + at(wrow + 8, p) + 16 * t);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint4 b = *reinterpret_cast<const uint4*>(xs + at(8 * j + g, p) + 16 * t);
        ptx::mma_s8(part[j], {lo.x, hi.x, lo.y, hi.y}, b.x, b.y);
        ptx::mma_s8(part[j], {lo.z, hi.z, lo.w, hi.w}, b.z, b.w);
      }
      if ((kt + 1) % bk_tiles == 0 || kt + 1 == kt_end) {
        // a K-block's sum ends: scale it in (past kt_end the sum is 0)
        const unsigned scale =
            static_cast<unsigned>(block_scale[min(kt, kt_end - 1) / bk_tiles]);
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[j][i] = static_cast<int>(static_cast<unsigned>(acc[j][i]) +
                                         static_cast<unsigned>(part[j][i]) * scale);
            part[j][i] = 0;
          }
      }
    }
  }
  ptx::cp_async_wait<0>();

  // fragment element i of n8 tile j: column n0 + wrow + 8 (i / 2), row
  // m0 + 8 j + 2 t + i % 2
  if (n_splits == 1) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 8 * j + 2 * t + (i & 1), n = n0 + wrow + 8 * (i >> 1);
        if (m < M && n < N)
          out[static_cast<size_t>(m) * N + n] = dequant(acc[j][i], fx[j][i & 1], fw[i >> 1]);
      }
    return;
  }
  // the partial tile into this block's (idle) ring, for the cluster to read
  __syncthreads();
  int* part_tile = reinterpret_cast<int*>(smem_raw);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part_tile[(8 * j + 2 * t + (i & 1)) * kBlockN + wrow + 8 * (i >> 1)] = acc[j][i];
  ptx::cluster_sync();
  // every read of the others' partials in flight at once
  unsigned sum[kBatch][4] = {};
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = rank + n_splits * (tid + b * kThreads);
      if (r < n_splits && q < kQuads) {
        const uint4 v = ptx::ld_cluster_v4(part_tile + 4 * q, r);
        sum[b][0] += v.x, sum[b][1] += v.y, sum[b][2] += v.z, sum[b][3] += v.w;
      }
    }
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int q = rank + n_splits * (tid + b * kThreads);
    const int m = m0 + 4 * q / kBlockN, n = n0 + 4 * q % kBlockN;
    if (q >= kQuads || m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n + c < N)
        out[static_cast<size_t>(m) * N + n + c] =
            dequant(static_cast<int>(sum[b][c]), bx[b], bw[b][c]);
  }
  ptx::cluster_sync();  // no block leaves while another reads its partials
}

template <int J, int S>
int launch(dim3 grid, cudaStream_t st, const int8_t* x, const int8_t* wt,
           const int* bs, const float* sx, const float* sw, float* out, int M,
           int N, int K, int bk_tiles, int split_tiles) {
  static size_t opted_in = 48 << 10;
  const size_t smem = kStages * (kBlockN + 8 * J) * S * kTileK;
  if (grid.y == 1)  // one split: no cluster
    return klaunch::launch_kernel(muxq_gemm_kernel<J, S>, &opted_in, grid, kThreads,
                                  smem, st, x, wt, bs, sx, sw, out, M, N, K,
                                  bk_tiles, split_tiles);
  return klaunch::launch_clusters(muxq_gemm_kernel<J, S>, &opted_in, grid,
                                  dim3(1, grid.y, 1), kThreads, smem, st, x, wt,
                                  bs, sx, sw, out, M, N, K, bk_tiles, split_tiles);
}

struct Plan {
  int rows;         // token rows a block (8 J)
  int stage;        // K tiles a pipeline stage
  int split_tiles;  // K tiles a split
  int n_splits;     // splits: gridDim.y, the blocks of a cluster
};

// K (a multiple of kTileK) is split evenly, in whole stages (the last
// split's last stage may be short), into the fewest splits (at most
// kMaxSplits) that give the grid kBlocksPerSm blocks a SM
Plan make_plan(int M, int N, int K, int n_sm) {
  Plan p;
  p.rows = M >= kMaxRows ? kMaxRows : (M + 7) / 8 * 8;
  const int k_tiles = K / kTileK;
  p.stage = p.rows == 8 ? kDecodeStage : kStage;
  const int units = (k_tiles + p.stage - 1) / p.stage;
  const long long base = static_cast<long long>((N + kBlockN - 1) / kBlockN) *
                         ((M + p.rows - 1) / p.rows);
  int per = units;
  for (int want = 1; want <= kMaxSplits && want <= units; ++want) {
    per = (units + want - 1) / want;
    if (base * ((units + per - 1) / per) >= static_cast<long long>(kBlocksPerSm) * n_sm)
      break;
  }
  p.split_tiles = per * p.stage;
  p.n_splits = (units + per - 1) / per;
  return p;
}

bool valid(int M, int N, int K, int bk, int n_sm) {
  return M >= 0 && N >= 0 && K > 0 && K % kTileK == 0 && bk > 0 && bk % kTileK == 0 &&
         K % bk == 0 && n_sm > 0;
}

}  // namespace

// The grid plan of a call on a card of n_sm SMs, as muxq_gemm_launch takes
// it: plan[0..3] = token rows a block, K tiles a stage, K tiles a split,
// splits.
extern "C" int muxq_gemm_plan(int M, int N, int K, int n_sm, int* plan) {
  if (!valid(M, N, K, kTileK, n_sm)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N, K, n_sm);
  plan[0] = p.rows, plan[1] = p.stage, plan[2] = p.split_tiles, plan[3] = p.n_splits;
  return 0;
}

// x int8 [M, K] and wt int8 [N, K] (W^T: k-major, 16-byte aligned rows),
// block_scale int32 [K / bk], sx f32 [M], sw f32 [N] -> out f32 [M, N].
// K and bk are multiples of 64; n_sm: the card's SMs (the plan's target).
extern "C" int muxq_gemm_launch(const void* x, const void* wt,
                                const void* block_scale, const void* sx,
                                const void* sw, void* out, int M, int N, int K,
                                int bk, int n_sm, void* stream) {
  if (!valid(M, N, K, bk, n_sm)) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const Plan p = make_plan(M, N, K, n_sm);
  const dim3 grid((N + kBlockN - 1) / kBlockN, p.n_splits, (M + p.rows - 1) / p.rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wt);
  const auto* bs = static_cast<const int*>(block_scale);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  auto* o = static_cast<float*>(out);
  const int bkt = bk / kTileK, spt = p.split_tiles;
  switch (p.rows / 8) {
    case 1: return launch<1, kDecodeStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    case 2: return launch<2, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    case 3: return launch<3, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    case 4: return launch<4, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    case 5: return launch<5, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    case 6: return launch<6, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    case 7: return launch<7, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
    default: return launch<kMaxRows / 8, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, K, bkt, spt);
  }
}
