"""Where the attention kernels' time goes, on the card (H100).

    python3 tools/attention_probe.py [profile] [timeline] [flash-timeline]
        [flash-grid] [sass] [order] [cell[=PARENT_DIR]]

- ``profile``: device time per CUDA kernel (torch.profiler, warm, mean of
  50 calls) of ``paged_attention`` at ``chip_smoke.py``'s timing shapes
  and at the prefill chunk of the benchmark's cell (the partials kernel and
  the merge apart) and of ``flash_attention`` at b 1, s 2048, 14/2 heads,
  dh 64, causal.
- ``timeline``: the paged kernel's phases at decode and prefill, the
  cell's chunk under both tiles, from an instrumented copy of ``csrc``
  built into ``build/attention_probe/``.
  Thread 0 of each block records ``clock64`` after the prologue, after the
  first tile lands, after its dequantization and after the last tile's
  update, and sums over its key tiles the cycles spent waiting for a tile
  to land, dequantizing (with the barrier after) and updating (scores,
  softmax and P.V, each with the barrier after); ``%globaltimer`` at block
  entry and exit gives the kernel's span, the mean block and the tail
  (from the last block's start to the kernel's end).  Block (0, 0, 0) of
  the row tile also splits its first tile update into scores, softmax
  (with the normalization of a single tile) and P.V.  Printed in
  microseconds at the SM clock that ``nvidia-smi`` reports.
- ``cell``: the prefill chunk of the cell (qwen2.5-14b: 3 slots of sq 512,
  40/8 heads of 128, int8 pages) at depths 0, 1536 and 3584 and at all
  three at once: cold device time (median of 5 sets of 10, a 64 MB read
  ahead of each run) of the chunk tile, the 64-row tile on the same
  inputs and the plain version, beside the f32 bound; the two tiles' and,
  with ``cell=PARENT_DIR`` (a ``git archive`` of an earlier commit), that
  commit's kernel's outputs compared bit for bit.
- ``flash-timeline``: ``flash_attention`` at the same shape, from an
  instrumented copy: per block, the cycles waiting for K/V tiles to land
  against the cycles updating with them, summed over its items; block
  (0, 0, 0)'s first tile update split into scores, softmax and P.V.
- ``flash-grid``: ``flash_attention``'s work queue with 1, 2, 3 or all
  resident blocks per SM, and with paired query tiles as items (copies of
  the source, median of 5 sets of 20 cold runs each).
- ``sass``: SASS instructions per kernel function of the built attention
  libraries (``cuobjdump``): what a block that runs its code once must
  fetch.
- ``order``: the summation order of the plain version's two einsums on
  the card (the share of outputs bit-equal to a sequential fmaf chain and
  to other orders), and the paged kernel against the plain version, bit
  for bit, on single-tile tables (the in-situ shapes of ``chip_smoke.py``)
  and on a split one.

Every line carries the card's name and power limit.  Nothing here runs on
the serving path; the instrumented copies are built with the port's own
``nvcc`` flags.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.serve import kvq  # noqa: E402
from repro_torch.serve.kvcache import quantize_kv  # noqa: E402

OUT = ROOT / "build" / "attention_probe"
N_TAB, PS, DH = 8, 16, 64
# label, page mode, sq, query heads, KV heads, slot positions (chip_smoke.py)
PAGED_SHAPES = (
    ("gpt2 decode int8", "int8", 1, 12, 12, [127, 100, 64, 40]),
    ("qwen2 decode fp", "fp", 1, 14, 2, [127, 100, 64, 40]),
    ("qwen2 decode int4", "int4", 1, 14, 2, [127, 100, 64, 40]),
    ("qwen2 verify int4", "int4", 4, 14, 2, [124, 97, 61, 37]),
    ("qwen2 prefill int4", "int4", 32, 14, 2, [96, 64, 32, 0]),
    ("gpt2 prefill int8", "int8", 32, 12, 12, [32, 0]),
)
# the benchmark's cell (qwen2.5-14b.prefill): chunks of 512 on int8 pages,
# 40 query heads over 8 KV heads of 128, tables of 264 pages of 16
CELL = dict(mode="int8", sq=512, heads=40, kvh=8, dh=128, n_tab=264)
CELL_DEPTHS = (("depths 0/1536/3584", [0, 1536, 3584]), ("depth 0", [0] * 3),
               ("depth 1536", [1536] * 3), ("depth 3584", [3584] * 3))
# (label, page mode, sq, heads, kvh, positions, dh, table pages) of every
# shape the profile and the timeline take
ALL_SHAPES = tuple(s + (DH, N_TAB) for s in PAGED_SHAPES) + (
    ("qwen2.5-14b prefill int8", "int8", 512, 40, 8, [0, 1536, 3584], 128, 264),)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def paged_inputs(mode, sq, heads, kvh, pos_list, dev, dh=DH, n_tab=N_TAB):
    g = torch.Generator().manual_seed(7 + sq)
    b = len(pos_list)
    q = torch.randn(b, sq, heads, dh, generator=g).to(dev)
    k = torch.randn(b * n_tab + 1, PS, kvh, dh, generator=g).to(dev)
    v = torch.randn(b * n_tab + 1, PS, kvh, dh, generator=g).to(dev)
    kw = {}
    if mode == "int8":
        parts = quantize_kv(k, v)
        k, v = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
    elif mode == "int4":
        mask = np.zeros((kvh, dh), bool)
        mask[:, [5, dh // 2 + 5]] = True
        red = torch.from_numpy(kvq.redist_from_mask(mask)).to(dev)
        parts = kvq.Int4KVQuantizer(red, red).quantize(k, v)
        k, v = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"],
              "k_redist": red, "v_redist": red}
    table = torch.arange(1, 1 + b * n_tab, dtype=torch.int32,
                         device=dev).reshape(b, n_tab)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    return (q, k, v, table, pos), kw


def flash_inputs(dtype, dev):
    g = torch.Generator().manual_seed(5)
    return tuple(torch.randn(1, 2048, n, 64, generator=g).to(dev, dtype)
                 for n in (14, 2, 2))


def profile(dev, card):
    from torch.profiler import ProfilerActivity, profile as prof

    def per_kernel(fn, n):
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key.split("(")[0][-48:], e.self_device_time_total / n)
                for e in p.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        return "; ".join(f"{k} {t:.2f} us" for k, t in sorted(rows, key=lambda r: -r[1]))

    for label, mode, sq, heads, kvh, pos, dh, n_tab in ALL_SHAPES:
        args, kw = paged_inputs(mode, sq, heads, kvh, pos, dev, dh, n_tab)
        print(f"profile {label}: {per_kernel(lambda: PA.paged_attention_decode(*args, **kw), 50)}"
              f"  [{card}]", flush=True)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(dt, dev)
        print(f"profile flash {str(dt)[6:]}: "
              f"{per_kernel(lambda: FA.flash_attention(q, k, v, causal=True), 10)}"
              f"  [{card}]", flush=True)


def _nvcc(src_dir: Path, name: str) -> ctypes.CDLL:
    lib = src_dir / f"lib{name}.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src_dir / f"{name}.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout[-4000:] + r.stderr[-4000:])
    return ctypes.CDLL(str(lib))


def _patch(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


TIMELINE_SLOTS = 16     # int64s a block records


def timeline(dev, card):
    src = OUT / "timeline"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    cu = (src / "paged_attention.cu").read_text()
    clock_ns = ("  long long gt;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                "\"=l\"(gt));\n")
    cu = _patch(cu, (
        ("  float scale, softcap;\n};\n\n// int4 code",
         "  float scale, softcap;\n  long long* dbg;\n};\nlong long* g_dbg = nullptr;\n\n"
         "// int4 code"),
        ("  const int tid = threadIdx.x, warp = tid >> 5;\n  const int sp = blockIdx.x;\n",
         "  const long long c0 = clock64();\n  long long c_wait = 0, c_deq = 0, c_upd = 0, c_pv = 0, c_a = 0;\n"
         f"  long long* dbg = p.dbg + {TIMELINE_SLOTS}ll * (blockIdx.x + gridDim.x * "
         "(blockIdx.y + gridDim.y * blockIdx.z));\n"
         "  {\n" + clock_ns + "  if (threadIdx.x == 0) dbg[8] = gt;\n  }\n"
         "  const int tid = threadIdx.x, warp = tid >> 5;\n  const int sp = blockIdx.x;\n"),
        ("  __syncthreads();  // page ids (and the rest) are set up\n",
         "  __syncthreads();  // page ids (and the rest) are set up\n  if (tid == 0) dbg[0] = clock64() - c0;\n"),
        ("    const int t0 = key_begin + it * kBk, nk = min(kBk, key_end - t0);\n    if constexpr (kScaled) {\n"
         "      if (tid < 2 * kBk) sc[tid] = pending;",
         "    const int t0 = key_begin + it * kBk, nk = min(kBk, key_end - t0);\n    c_a = clock64();\n"
         "    if constexpr (kScaled) {\n      if (tid < 2 * kBk) sc[tid] = pending;"),
        ("    __syncthreads();  // tile it's rows have landed; tile it - 1 is consumed\n",
         "    __syncthreads();  // tile it's rows have landed; tile it - 1 is consumed\n"
         "    if (tid == 0 && it == 0) dbg[1] = clock64() - c0;\n"
         "    c_wait += clock64() - c_a;\n    c_a = clock64();\n"),
        ("      dequant(ks, rk, sc, red);\n      __syncthreads();\n",
         "      dequant(ks, rk, sc, red);\n      __syncthreads();\n"
         "      if (tid == 0 && it == 0) dbg[2] = clock64() - c0;\n"
         "      c_deq += clock64() - c_a;\n      c_a = clock64();\n"),
        ("      __syncthreads();  // every warp is done with K\n",
         "      __syncthreads();  // every warp is done with K\n"
         "      c_upd += clock64() - c_a;\n      c_a = clock64();\n"),
        ("      dequant(vs, rv, sc + kBk, red + kDh);\n      __syncthreads();\n",
         "      dequant(vs, rv, sc + kBk, red + kDh);\n      __syncthreads();\n"
         "      c_deq += clock64() - c_a;\n      c_a = clock64();\n"),
        ("      if (warp * 16 < rows_t) st.accumulate(s, vs, nk);\n",
         "      if (warp * 16 < rows_t) st.accumulate(s, vs, nk);\n      c_pv += clock64() - c_a;\n"
         "      c_upd += clock64() - c_a;\n"),
        ("      __syncthreads();\n      if (warp * 16 < rows_t) {\n        st.consume(",
         "      __syncthreads();\n      if (tid == 0 && it == 0) dbg[2] = clock64() - c0;\n"
         "      c_deq += clock64() - c_a;\n      c_a = clock64();\n"
         "      if (warp * 16 < rows_t) {\n        st.consume("),
        ("                   p.n_split == 1 && n_tiles == 1);\n      }\n",
         "                   p.n_split == 1 && n_tiles == 1);\n      }\n"
         "      c_upd += clock64() - c_a;\n"),
        ("  if (warp * 16 >= rows_t) return;\n  st.finish();",
         "  if (tid == 0) {\n    dbg[3] = clock64() - c0;\n    dbg[4] = c_wait;\n    dbg[5] = c_deq;\n"
         "    dbg[6] = c_upd;\n    dbg[7] = c_pv;\n" + clock_ns + "    dbg[9] = gt;\n  }\n"
         "  if (warp * 16 >= rows_t) return;\n  st.finish();"),
        ("  p.scale = scale, p.softcap = softcap;\n  cudaStream_t st",
         "  p.scale = scale, p.softcap = softcap;\n  p.dbg = g_dbg;\n  cudaStream_t st"),
    ))
    cu += ('\nextern "C" void probe_set(void* p) { g_dbg = static_cast<long long*>(p); }\n'
           'extern "C" void probe_phases(long long* out) {\n'
           '  cudaMemcpyFromSymbol(out, attn::g_ph, sizeof(attn::g_ph));\n}\n')
    (src / "paged_attention.cu").write_text(cu)
    h = (src / "attention_common.cuh").read_text()
    h = _patch(h, (
        ("namespace attn {\n", "namespace attn {\n__device__ long long g_ph[4];\n"),
        ("    scores(qs, ks, n_keys, s);\n",
         "    const bool rec = blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0;\n"
         "    if (rec) g_ph[0] = clock64();\n    scores(qs, ks, n_keys, s);\n"
         "    if (rec) g_ph[1] = clock64() + (s[0][0] == 1.2345f);\n"),
        ("    accumulate(s, vs, n_keys);\n  }",
         "    if (rec) g_ph[2] = clock64() + (s[0][0] == 1.2345f);\n"
         "    accumulate(s, vs, n_keys);\n"
         "    if (rec) g_ph[3] = clock64() + (o[0][0] == 1.2345f);\n  }"),
    ))
    (src / "attention_common.cuh").write_text(h)
    so = _nvcc(src, "paged_attention")
    fn = so.paged_attention_launch
    fn.argtypes = build.SIGNATURES["paged_attention"]
    fn.restype = ctypes.c_int
    so.probe_set.argtypes = [ctypes.c_void_p]
    saved = build._LAUNCHERS.get("paged_attention")
    build._LAUNCHERS["paged_attention"] = fn
    dbg = torch.zeros(TIMELINE_SLOTS * 8192, dtype=torch.int64, device=dev)
    so.probe_set(dbg.data_ptr())
    mhz = float(smi("clocks.sm"))
    flush = torch.zeros(16 << 20, device=dev)
    chunk_tile = PA.chunk_tile
    shapes = [s + ("",) for s in ALL_SHAPES] + [ALL_SHAPES[-1] + ("row tile",)]
    try:
        for label, mode, sq, heads, kvh, pos, dh, n_tab, forced in shapes:
            args, kw = paged_inputs(mode, sq, heads, kvh, pos, dev, dh, n_tab)
            if forced:
                PA.chunk_tile = lambda rows, dh_, f32: False
                label = f"{label} [{forced}]"
            rows = sq * heads // kvh
            n_rt, _, n_split = PA.plan_splits(len(pos), kvh, rows, n_tab, PS, dh,
                                              build.sm_count(dev))
            n_blk = n_split * n_rt * len(pos) * kvh
            for cold in (False, True):
                PA.paged_attention_decode(*args, **kw)
                torch.cuda.synchronize()
                if cold:
                    flush.sum()
                dbg.zero_()
                PA.paged_attention_decode(*args, **kw)
                torch.cuda.synchronize()
                d = dbg[:TIMELINE_SLOTS * n_blk].view(n_blk, TIMELINE_SLOTS).cpu().numpy()
                d = d[d[:, 0] > 0]          # empty splits record nothing
                cyc = d[:, :8] / mhz
                start, end = d[:, 8], d[:, 9]
                span = (end.max() - start.min()) / 1e3
                ph = (ctypes.c_longlong * 4)()
                so.probe_phases(ph)
                work = cyc[:, 4:7].sum(1)
                print(f"timeline {label} ({'cold' if cold else 'warm'} L2, "
                      f"{n_blk} blocks, {len(d)} non-empty), us since block "
                      f"entry, mean (max): prologue {cyc[:, 0].mean():.2f}, "
                      f"first tile landed {cyc[:, 1].mean():.2f}, dequantized "
                      f"{cyc[:, 2].mean():.2f}, last tile updated {cyc[:, 3].mean():.2f} "
                      f"({cyc[:, 3].max():.2f}); block sums: waiting "
                      f"{cyc[:, 4].sum() / work.sum():.1%}, dequantizing "
                      f"{cyc[:, 5].sum() / work.sum():.1%}, updating "
                      f"{cyc[:, 6].sum() / work.sum():.1%} (P.V of the chunk tile "
                      f"{cyc[:, 7].sum() / work.sum():.1%}); span {span:.1f} us, block "
                      f"mean {(end - start).mean() / 1e3:.1f} (max "
                      f"{(end - start).max() / 1e3:.1f}), last start to end "
                      f"{(end.max() - start.max()) / 1e3:.1f}; block 0's first update: "
                      f"scores {(ph[1] - ph[0]) / mhz:.2f}, softmax {(ph[2] - ph[1]) / mhz:.2f}, "
                      f"P.V {(ph[3] - ph[2]) / mhz:.2f}  [{card}]", flush=True)
            PA.chunk_tile = chunk_tile
    finally:
        PA.chunk_tile = chunk_tile
        if saved is None:
            build._LAUNCHERS.pop("paged_attention", None)
        else:
            build._LAUNCHERS["paged_attention"] = saved


CONSUME_PHASES = (
    ("namespace attn {\n", "namespace attn {\n__device__ long long g_ph[4];\n"),
    ("    scores(qs, ks, n_keys, s);\n",
     "    const bool rec = blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0;\n"
     "    if (rec && g_ph[3] == 0) g_ph[0] = clock64();\n    scores(qs, ks, n_keys, s);\n"
     "    if (rec && g_ph[3] == 0) g_ph[1] = clock64() + (s[0][0] == 1.2345f);\n"),
    ("    accumulate(s, vs, n_keys);\n  }",
     "    if (rec && g_ph[3] == 0) g_ph[2] = clock64() + (s[0][0] == 1.2345f);\n"
     "    accumulate(s, vs, n_keys);\n"
     "    if (rec && g_ph[3] == 0) g_ph[3] = clock64() + (o[0][0] == 1.2345f);\n  }"),
)


def flash_timeline(dev, card):
    src = OUT / "flash_timeline"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    cu = _patch((src / "flash_attention.cu").read_text(), (
        ("  int* next;  // the work queue's counter, zero at launch\n",
         "  int* next;  // the work queue's counter, zero at launch\n  long long* dbg;\n"),
        ("  int* item_s = reinterpret_cast<int*>(kv_tiles + 4 * kBk * kLd);\n",
         "  int* item_s = reinterpret_cast<int*>(kv_tiles + 4 * kBk * kLd);\n"
         "  const long long c_entry = clock64();\n  long long c_wait = 0, c_update = 0, n_items = 0;\n"),
        ("      const int kt = first + it * kBk, nk = min(kBk, p.sk - kt);\n      if (it + 1 < n_tiles) {",
         "      const int kt = first + it * kBk, nk = min(kBk, p.sk - kt);\n      const long long c0 = clock64();\n"
         "      if (it + 1 < n_tiles) {"),
        ("      __syncthreads();  // tile it (and the query tile) has landed\n",
         "      __syncthreads();  // tile it (and the query tile) has landed\n      const long long c1 = clock64();\n"),
        ("      __syncthreads();  // tile it is consumed before its stage is refilled\n",
         "      __syncthreads();  // tile it is consumed before its stage is refilled\n"
         "      c_wait += c1 - c0;\n      c_update += clock64() - c1;\n"),
        ("    if (item >= n_items) break;\n",
         "    if (item >= n_items) break;\n    ++n_items_done;\n"),
        ("  const int n_items = n_qt * p.h * p.b;\n",
         "  const int n_items = n_qt * p.h * p.b;\n  long long n_items_done = 0;\n"),
        ("    process((n_qt - 1 - item / (p.h * p.b)) * kRows, hb % p.h, hb / p.h);\n  }\n}",
         "    process((n_qt - 1 - item / (p.h * p.b)) * kRows, hb % p.h, hb / p.h);\n  }\n"
         "  if (tid == 0) {\n    long long* d = p.dbg + 4 * blockIdx.x;\n"
         "    d[0] = c_wait; d[1] = c_update; d[2] = clock64() - c_entry; d[3] = n_items_done;\n  }\n}"),
    ))
    cu = cu.replace("long long c_wait = 0, c_update = 0, n_items = 0;", "long long c_wait = 0, c_update = 0;")
    cu = cu.replace("  Params p{q, k, v, out, static_cast<int*>(next), b, sq, sk, h, kv, dh,\n           causal, window};",
                    "  Params p{q, k, v, out, static_cast<int*>(next), g_dbg, b, sq, sk, h, kv, dh,\n           causal, window};")
    if "g_dbg, b, sq" not in cu:
        raise RuntimeError("flash_attention.cu no longer builds its Params as expected")
    cu = cu.replace("namespace {\n", "namespace {\nlong long* g_dbg = nullptr;\n", 1)
    cu += ('\nextern "C" void probe_set(void* p) { g_dbg = static_cast<long long*>(p); }\n'
           'extern "C" void probe_phases(long long* out) {\n'
           '  cudaMemcpyFromSymbol(out, attn::g_ph, sizeof(attn::g_ph));\n}\n'
           'extern "C" void probe_reset() {\n  const long long z[4] = {0, 0, 0, 0};\n'
           '  cudaMemcpyToSymbol(attn::g_ph, z, sizeof(z));\n}\n')
    (src / "flash_attention.cu").write_text(cu)
    h = _patch((src / "attention_common.cuh").read_text(), CONSUME_PHASES)
    (src / "attention_common.cuh").write_text(h)
    so = _nvcc(src, "flash_attention")
    fn = so.flash_attention_launch
    fn.argtypes = build.SIGNATURES["flash_attention"]
    fn.restype = ctypes.c_int
    so.probe_set.argtypes = [ctypes.c_void_p]
    saved = build._LAUNCHERS.get("flash_attention")
    build._LAUNCHERS["flash_attention"] = fn
    dbg = torch.zeros(4 * 4096, dtype=torch.int64, device=dev)
    so.probe_set(dbg.data_ptr())
    mhz = float(smi("clocks.sm"))
    try:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(dt, dev)
            FA.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            dbg.zero_()
            so.probe_reset()
            FA.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            d = dbg.view(-1, 4).cpu().numpy()
            d = d[d[:, 3] > 0]
            ph = (ctypes.c_longlong * 4)()
            so.probe_phases(ph)
            wait, upd, tot = (d[:, i].sum() / mhz for i in range(3))
            print(f"flash-timeline {str(dt)[6:]}: {len(d)} blocks, {int(d[:, 3].sum())} "
                  f"query tiles; per block mean {d[:, 2].mean() / mhz:.1f} us (max "
                  f"{d[:, 2].max() / mhz:.1f}): waiting for tiles {wait / tot:.1%}, "
                  f"updating {upd / tot:.1%}; block 0's first update: scores "
                  f"{(ph[1] - ph[0]) / mhz:.3f}, softmax {(ph[2] - ph[1]) / mhz:.3f}, "
                  f"P.V {(ph[3] - ph[2]) / mhz:.3f} us  [{card}]", flush=True)
    finally:
        if saved is None:
            build._LAUNCHERS.pop("flash_attention", None)
        else:
            build._LAUNCHERS["flash_attention"] = saved


def flash_grid(dev, card):
    base = (build.CSRC / "flash_attention.cu").read_text()
    per_sm = "    resident = sms * min(per_sm, kBlocksPerSm);\n"
    loop = ("    const int hb = item % (p.h * p.b);\n"
            "    process((n_qt - 1 - item / (p.h * p.b)) * kRows, hb % p.h, hb / p.h);")
    pairs = _patch(base, (
        (loop, "    const int hb = item % (p.h * p.b), x = item / (p.h * p.b);\n"
               "    process((n_qt - 1 - x) * kRows, hb % p.h, hb / p.h);\n"
               "    if (x < n_qt - 1 - x) process(x * kRows, hb % p.h, hb / p.h);"),
        ("const int n_items = n_qt * p.h * p.b;",
         "const int n_items = (n_qt + 1) / 2 * p.h * p.b;"),
        ("const int n_items = (p.sq + kRows - 1) / kRows * p.h * p.b;",
         "const int n_items = ((p.sq + kRows - 1) / kRows + 1) / 2 * p.h * p.b;"),
    ))
    variants = {f"queue, {k} a SM": _patch(base, ((per_sm, f"    resident = sms * min(per_sm, {k});\n"),))
                for k in (1, 2, 3)}
    variants["queue, all resident"] = _patch(base, ((per_sm, "    resident = sms * per_sm;\n"),))
    variants["paired tiles, 2 a SM"] = pairs
    fns = {}
    for i, (name, text) in enumerate(variants.items()):
        d = OUT / f"flash{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        (d / "flash_attention.cu").write_text(text)
        fn = _nvcc(d, "flash_attention").flash_attention_launch
        fn.argtypes = build.SIGNATURES["flash_attention"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    flush = torch.zeros(16 << 20, device=dev)
    saved = build._LAUNCHERS.get("flash_attention")
    try:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(dt, dev)
            for name, fn in fns.items():
                build._LAUNCHERS["flash_attention"] = fn
                FA.flash_attention(q, k, v, causal=True)
                sets = []
                for _ in range(5):
                    total = 0.0
                    for _ in range(20):
                        flush.sum()
                        torch.cuda._sleep(200_000)
                        a = torch.cuda.Event(enable_timing=True)
                        b = torch.cuda.Event(enable_timing=True)
                        a.record()
                        FA.flash_attention(q, k, v, causal=True)
                        b.record()
                        torch.cuda.synchronize()
                        total += a.elapsed_time(b)
                    sets.append(total / 20 * 1e3)
                sets.sort()
                print(f"flash-grid {str(dt)[6:]} [{name}]: {sets[2]:.1f} us "
                      f"(sets {sets[0]:.1f}-{sets[-1]:.1f})  [{card}]", flush=True)
    finally:
        if saved is None:
            build._LAUNCHERS.pop("flash_attention", None)
        else:
            build._LAUNCHERS["flash_attention"] = saved


def sass(dev, card):
    import re
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    for name in ("paged_attention", "flash_attention"):
        lib = build._target(name)[1]
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        counts, fn = {}, None
        for line in text.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                counts[fn] += 1
        for fn, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            short = re.sub(r"_ZN\w*?(paged_attention_kernel|flash_attention_kernel|combine_kernel)",
                           r"\1", fn)[:90]
            print(f"sass {name}: {n} instructions ({n * 16 / 1024:.0f} KB) {short}  [{card}]")


DOTS_CU = r"""
#include <cuda_runtime.h>
// out[i, j] = sum_d x[i, d] y[j, d] in the order `mode` names
__global__ void dots(const float* x, const float* y, float* out, int n_x,
                     int n_y, int n, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_x * n_y) return;
  const float* a = x + (i / n_y) * n;
  const float* b = y + (i % n_y) * n;
  float r = 0.f;
  if (mode == 0) {
    for (int d = 0; d < n; ++d) r = fmaf(a[d], b[d], r);
  } else if (mode == 1) {
    for (int d = n - 1; d >= 0; --d) r = fmaf(a[d], b[d], r);
  } else {
    const int chunk = mode == 2 ? 8 : 32;
    for (int c = 0; c < n; c += chunk) {
      float s = 0.f;
      for (int d = c; d < c + chunk && d < n; ++d) s = fmaf(a[d], b[d], s);
      r += s;
    }
  }
  out[i] = r;
}
extern "C" int dots_launch(const float* x, const float* y, float* out,
                           int n_x, int n_y, int n, int mode) {
  dots<<<(n_x * n_y + 127) / 128, 128>>>(x, y, out, n_x, n_y, n, mode);
  return static_cast<int>(cudaGetLastError());
}
"""


def order(dev, card):
    d = OUT / "order"
    d.mkdir(parents=True, exist_ok=True)
    (d / "dots.cu").write_text(DOTS_CU)
    fn = _nvcc(d, "dots").dots_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    names = ("sequential", "reverse", "chunks of 8", "chunks of 32")

    def chains(x, y):            # x [n_x, n], y [n_y, n] -> [n_x, n_y] per order
        outs = []
        for mode in range(len(names)):
            o = torch.empty(x.shape[0], y.shape[0], device=dev)
            fn(x.data_ptr(), y.data_ptr(), o.data_ptr(), x.shape[0], y.shape[0],
               x.shape[1], mode)
            outs.append(o)
        torch.cuda.synchronize()
        return outs

    for b, sq, kvh, g, n_keys in ((2, 4, 2, 7, 64), (2, 32, 2, 7, 64),
                                  (4, 1, 2, 7, 128), (4, 1, 12, 1, 128)):
        gen = torch.Generator().manual_seed(0)
        q = (torch.randn(b, sq, kvh, g, DH, generator=gen) * 3).to(dev)
        k = (torch.randn(b, n_keys, kvh, DH, generator=gen) * 3).to(dev)
        probs = torch.softmax(torch.randn(b, kvh, g, sq, n_keys, generator=gen),
                              -1).to(dev)
        scores = torch.einsum("bqkgd,bskd->bkgqs", q, k)
        pv = torch.einsum("bkgqs,bskd->bqkgd", probs, k)
        hit_s, hit_pv = [0] * len(names), [0] * len(names)
        for bi in range(b):
            for h in range(kvh):
                xs = q[bi, :, h].permute(1, 0, 2).reshape(-1, DH).contiguous()
                for m, o in enumerate(chains(xs, k[bi, :, h].contiguous())):
                    hit_s[m] += int((o == scores[bi, h].reshape(-1, n_keys)).sum())
                xp = probs[bi, h].reshape(-1, n_keys).contiguous()
                for m, o in enumerate(chains(xp, k[bi, :, h].t().contiguous())):
                    want = pv[bi, :, h].permute(1, 0, 2).reshape(-1, DH)
                    hit_pv[m] += int((o == want).sum())
        n_s, n_pv = scores.numel(), pv.numel()
        print(f"order b {b} sq {sq} kvh {kvh} g {g} keys {n_keys}: einsum outputs "
              f"bit-equal to a chain, scores: " + ", ".join(
                  f"{nm} {h / n_s:.3f}" for nm, h in zip(names, hit_s))
              + "; P.V: " + ", ".join(f"{nm} {h / n_pv:.3f}" for nm, h in zip(names, hit_pv))
              + f"  [{card}]", flush=True)
    for label, sq, pos, n_table, mode in (
            ("verify, 4 pages, int4", 4, [32, 30], 4, "int4"),
            ("prefill, 2 pages read, int4", 32, [0, 0], 4, "int4"),
            ("verify, 4 pages, f32", 4, [32, 30], 4, "fp"),
            ("decode, 8 pages (split), int4", 1, [127, 100], 8, "int4")):
        args, kw = paged_inputs(mode, sq, 14, 2, pos, dev)
        args = (args[0], args[1], args[2],
                args[3][:, :n_table].contiguous(), args[4])
        out = PA.paged_attention_decode(*args, **kw)
        plain = PA.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        print(f"order paged kernel vs plain, {label}: max abs err "
              f"{float((out - plain).abs().max()):.3e}, bit-equal "
              f"{float((out == plain).float().mean()):.4f}  [{card}]", flush=True)


def cold_ms(fn, flush, sets=5, iters=10):
    """Median over ``sets`` of the mean device time of ``iters`` runs, each
    after a 64 MB read that evicts L2 and a sleep that keeps the host's
    enqueue out of the events; and the sets' range."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(sets):
        total = 0.0
        for _ in range(iters):
            flush.sum()
            torch.cuda._sleep(200_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        means.append(total / iters)
    means.sort()
    return means[len(means) // 2], means[0], means[-1]


# the C launcher's arguments before the tile argument (index 21) came in
OLD_PAGED_SIGNATURE = build.SIGNATURES["paged_attention"][:21] + \
    build.SIGNATURES["paged_attention"][22:]


def cell(dev, card, parent=None):
    """The cell's prefill chunk: the two tiles (and an earlier commit's
    kernel) bit for bit, and their cold times beside the plain version's
    and the bound."""
    parent_fn = None
    if parent:
        src = Path(parent).resolve() / "src" / "repro_torch" / "csrc"
        lib = OUT / "parent_csrc"
        shutil.rmtree(lib, ignore_errors=True)
        shutil.copytree(src, lib)
        parent_fn = _nvcc(lib, "paged_attention").paged_attention_launch
        parent_fn.argtypes = OLD_PAGED_SIGNATURE
        parent_fn.restype = ctypes.c_int
    flush = torch.zeros(16 << 20, device=dev)
    c = CELL
    chunk_tile, saved = PA.chunk_tile, build.launcher("paged_attention")

    def run(tile, fn=None):
        """paged_attention_decode under ``tile`` ("chunk" or "row"), through
        ``fn`` in place of this tree's launcher where given"""
        PA.chunk_tile = chunk_tile if tile == "chunk" else (lambda r, d, f: False)
        if fn is not None:
            build._LAUNCHERS["paged_attention"] = lambda *a: fn(*(a[:21] + a[22:]))
        try:
            return PA.paged_attention_decode(*args, **kw)
        finally:
            PA.chunk_tile = chunk_tile
            build._LAUNCHERS["paged_attention"] = saved

    for label, pos in CELL_DEPTHS:
        args, kw = paged_inputs(c["mode"], c["sq"], c["heads"], c["kvh"], pos, dev,
                                c["dh"], c["n_tab"])
        b = len(pos)
        pairs = sum(p + i + 1 for p in pos for i in range(c["sq"]))
        ops = 4 * c["dh"] * c["heads"] * pairs
        n_read = sum(min(c["n_tab"], (p + c["sq"] - 1) // PS + 1) for p in pos)
        nbytes = (n_read * PS * c["kvh"] * 2 * (c["dh"] + 4)
                  + 2 * 4 * b * c["sq"] * c["heads"] * c["dh"])
        bound_ms = max(ops / 67e12, nbytes / 3.35e12) * 1e3
        out = run("chunk")
        rows_out = run("row")
        plain = PA.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        line = (f"cell {label}: chunk vs row tile bit-equal "
                f"{bool(torch.equal(out, rows_out))}, max |chunk - plain| "
                f"{float((out - plain).abs().max()):.3e}")
        if parent_fn is not None:
            old = run("row", parent_fn)
            torch.cuda.synchronize()
            line += (f", chunk vs {parent} bit-equal {bool(torch.equal(out, old))} "
                     f"(bits {float((out.view(torch.int32) == old.view(torch.int32)).float().mean()):.6f})")
        times = {"chunk": cold_ms(lambda: run("chunk"), flush),
                 "row": cold_ms(lambda: run("row"), flush)}
        if parent_fn is not None:
            times["parent"] = cold_ms(lambda: run("row", parent_fn), flush)
        times["plain"] = cold_ms(lambda: PA.paged_attention_plain(*args, **kw), flush,
                                 sets=3, iters=3)
        line += "; cold ms: " + ", ".join(
            f"{k} {t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}] ({100 * bound_ms / t[0]:.1f} % of bound)"
            for k, t in times.items())
        print(f"{line}; bound {bound_ms:.4f} ms (f32 operations)  [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    build.build(["paged_attention", "flash_attention"])
    OUT.mkdir(parents=True, exist_ok=True)
    todo = sys.argv[1:] or ["profile", "timeline", "flash-timeline", "flash-grid",
                            "sass", "order", "cell"]
    for what in todo:
        what, _, arg = what.partition("=")
        if what == "cell":
            cell(dev, card, arg or None)
            continue
        {"profile": profile, "timeline": timeline, "flash-timeline": flash_timeline,
         "flash-grid": flash_grid, "sass": sass, "order": order}[what](dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
