#!/usr/bin/env python3
"""The GEMM and quantize kernels on the card: the current ones beside an
earlier commit's, edited copies of their sources, and where the GEMM's
time goes.

    python3 tools/gemm_probe.py [compare DIR] [variants] [timeline] [profile]

``compare DIR`` builds ``muxq_gemm.cu`` and ``rowwise_quantize.cu`` from
``DIR/src/repro_torch/csrc`` (a checkout of an earlier commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) and times
them beside the current kernels at every serving shape, in turns (earlier,
current, current, earlier), each time as ``chip_smoke.time_ms`` does: cold
L2, CUDA-graph replay, the median of 5 sets with their spread.  Every
output is first held bit-equal to the plain version.  The earlier GEMM
reads W n-major [K, N] (its own copy); the current one reads the served
k-major copy.  Beside them: ``torch._int_mm`` on the same weight (X
zero-padded to 32 rows below M = 32, once, outside the timed call) and the
bound.

``variants`` builds copies of the current sources with a few lines changed
each (``VARIANTS``: the quantize's chunks held and x staging; the GEMM's
pipeline depth and stage size, rows and columns a block, and the blocks a
SM that its split plan aims at) and times them beside the current kernels
at the decode and prefill shapes; ``variants=NAME,...`` times only those
GEMM variants.

``breakdown`` times copies of the GEMM with one part taken out (the
MMAs, every global copy, the cluster's split-K tail) beside it, at a few
sites and M 4/64/128: where its time goes.  Their results are wrong by
design and not checked.

``timeline`` builds a copy of ``muxq_gemm.cu`` that stamps, from thread 0
of every block, the SM and ``%globaltimer`` at the kernel's phases (start,
prologue issued, first stage landed, K loop done, cluster barrier passed,
share of the tile summed and written, end), runs it cold at a few shapes and
prints the median and largest phase times over the blocks, and how late
the last block started (``%globaltimer`` ticks in steps of about 0.26 us
on the H100).

``profile`` gives each current kernel's own device time at a few serving
shapes (``torch.profiler``, warm, the mean of 50 launches) beside the
floor of the timing method: ``time_ms`` of a kernel that does nothing
(``torch.cuda._sleep(0)``) and of a one-element fill.

Prints one line per measurement beside the card's name and power limit;
everything goes to ``chiprun_out/gemm_probe.json`` too.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import muxq_gemm as G  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as RQ  # noqa: E402

OUT = ROOT / "build" / "gemm_probe"

# (K_pad, N) of every site of the served models, each with a calibrated
# outlier run (chip_smoke.py prints the artifacts' own)
SITES = {"gpt2 attn_qkv": (1536, 2304), "gpt2 attn_out": (1536, 768),
         "gpt2 mlp_up": (1536, 3072), "gpt2 mlp_down": (3584, 768),
         "qwen2 attn_qkv": (1536, 1152), "qwen2 attn_out": (1536, 896),
         "qwen2 mlp_up": (1536, 9728), "qwen2 mlp_down": (5632, 896)}
# decode, qwen2 verify, prefill (4 slots x a chunk bucket of 16 or 32)
GEMM_M = (4, 20, 64, 128)
QUANT = {"gpt2 mlp_up": 768, "gpt2 mlp_down": 3072, "qwen2 mlp_up": 896,
         "qwen2 mlp_down": 4864}   # K_in of the quantize in front of a site
QUANT_M = (4, 64)

# edits of the current sources: {kernel: {name: [(old, new)]}}
VARIANTS = {
    "rowwise_quantize": {
        "1 chunk held": [("constexpr int kHeld = 4; ", "constexpr int kHeld = 1; ")],
        "x not staged": [("constexpr int kStageBytes = 96 << 10;",
                          "constexpr int kStageBytes = 0;")]},
    "muxq_gemm": {
        "decode stages of 1 tile": [("constexpr int kDecodeStage = 4;",
                                     "constexpr int kDecodeStage = 1;")],
        "32 rows a block": [("constexpr int kMaxRows = 64;", "constexpr int kMaxRows = 32;")],
        "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
        "2 blocks a SM": [("constexpr int kBlocksPerSm = 1;",
                           "constexpr int kBlocksPerSm = 2;")],
        "4 blocks a SM": [("constexpr int kBlocksPerSm = 1;",
                           "constexpr int kBlocksPerSm = 4;")],
        "6 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
        "128 columns a block": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
        "128 rows a block": [
            ("constexpr int kMaxRows = 64;", "constexpr int kMaxRows = 128;"),
            ("    default: return launch<kMaxRows / 8, kStage>(grid,",
             "    case 8: return launch<8, kStage>(grid, st, xp, wp, bs, sxp, swp, o, M, N, "
             "K, bkt, spt);\n    default: return launch<kMaxRows / 8, kStage>(grid,")],
        "1-tile stages above 8 rows": [("constexpr int kStage = 2;", "constexpr int kStage = 1;")],
        "4-tile stages above 8 rows": [("constexpr int kStage = 2;", "constexpr int kStage = 4;")],
        # (served K only: every split a whole number of stages)
        "no zero fill": [("      ptx::cp_async_zfill16(", "      ptx::cp_async<16>("),
                         ("                                min(p, tiles - 1) * kTileK + col,\n"
                          "                            p < tiles);",
                          "                                p * kTileK + col);")],
        "K loop left at the split's end": [
            ("      const int kt = kt0 + it * S + p;\n",
             "      const int kt = kt0 + it * S + p;\n      if (kt == kt_end) break;\n")],
        # each column block starts its K loop at another stage
        "staggered K order": [
            ("  const int nt = (kt_end - kt0 + S - 1) / S;            // stages\n",
             "  const int nt = (kt_end - kt0 + S - 1) / S;            // stages\n"
             "  const int rot = blockIdx.x % nt;\n"
             "  auto order = [&](int i) { return i + rot < nt ? i + rot : i + rot - nt; };\n"),
            ("    if (s < nt) load(s, s);", "    if (s < nt) load(s, order(s));"),
            ("load((it + kStages - 1) % kStages, it + kStages - 1);",
             "load((it + kStages - 1) % kStages, order(it + kStages - 1));"),
            ("      const int kt = kt0 + it * S + p;", "      const int kt = kt0 + order(it) * S + p;"),
            ("      if ((kt + 1) % bk_tiles == 0 || kt + 1 == kt_end) {",
             "      if ((kt + 1) % bk_tiles == 0 || kt + 1 == kt_end || (it == nt - 1 && p == S - 1)) {")]},
}
# copies with a part taken out, for ``breakdown``: timed only (their
# results are wrong by design)
_MMA = ("        ptx::mma_s8(part[j], {lo.x, hi.x, lo.y, hi.y}, b.x, b.y);\n",
        "        ptx::mma_s8(part[j], {lo.z, hi.z, lo.w, hi.w}, b.z, b.w);\n")
BREAKDOWN = {
    "no MMAs": [(_MMA[0], "        part[j][0] += lo.x ^ hi.y ^ b.x, part[j][1] += lo.z ^ hi.w ^ b.y;\n"),
                (_MMA[1], "        part[j][2] += lo.y ^ hi.x ^ b.z, part[j][3] += lo.w ^ hi.z ^ b.w;\n")],
    "no global copies": [("      ptx::cp_async_zfill16(", "      if (M < 0) ptx::cp_async_zfill16(")],
    "no split-K tail": [("  if (n_splits == 1) {\n#pragma unroll\n    for (int j = 0; j < J; ++j)\n"
                         "#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n        const int m",
                         "  if (true) {\n#pragma unroll\n    for (int j = 0; j < J; ++j)\n"
                         "#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n        const int m")],
}
# M 72-120 are not timed: "128 rows a block" launches them wrongly
VARIANTS["muxq_gemm"]["128 x 128 tiles"] = (VARIANTS["muxq_gemm"]["128 rows a block"]
                                            + VARIANTS["muxq_gemm"]["128 columns a block"])

_P, _I = ctypes.c_void_p, ctypes.c_int
EARLIER_SIGNATURES = {"muxq_gemm": [_P] * 6 + [_I] * 4 + [_P],
                      "rowwise_quantize": [_P] * 5 + [_I] * 5 + [_P]}


def build_earlier(src_dir: Path):
    """ctypes launchers of the earlier commit's two kernels."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = src_dir / "src" / "repro_torch" / "csrc"
    procs = {}
    for name in EARLIER_SIGNATURES:
        lib = OUT / f"lib{name}_earlier.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        fn.argtypes = EARLIER_SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def build_variants(todo):
    """{(kernel, name): launcher} of each ``kernel`` built from a copy of
    ``csrc`` with its edits applied to the source; ``todo`` maps (kernel,
    name) to the edits.  One nvcc each, all at once."""
    procs = {}
    for (kernel, name), subs in todo.items():
        d = OUT / f"{kernel}_{name.replace(' ', '_').replace(',', '')}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = d / build.SOURCES[kernel]
        text = src.read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{kernel} variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        src.write_text(text)
        lib = d / f"lib{kernel}.so"
        procs[(kernel, name)] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (kernel, name), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} variant {name!r}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
        fn.argtypes = build.SIGNATURES[kernel]
        fn.restype = ctypes.c_int
        fns[(kernel, name)] = (fn, lib)
    return fns


def gemm_plan(m, n, k, n_sm, lib=None):
    """The GEMM's grid plan from its C entry (``muxq_gemm_plan`` of the
    built library, or of ``lib``): (token rows a block, K tiles a stage,
    K tiles a split, splits)."""
    fn = ctypes.CDLL(str(lib or build._target("muxq_gemm")[1])).muxq_gemm_plan
    out = (ctypes.c_int * 4)()
    if fn(m, n, k, n_sm, out):
        raise RuntimeError(f"muxq_gemm_plan refused M={m} N={n} K={k}")
    return tuple(out)


# stamps of the timeline copy: slot 0 the SM, then the phases
PHASES = ("start", "prologue issued", "first stage", "K loop", "cluster barrier",
          "tile summed and written", "end")
TIMELINE_EDITS = (
    ("namespace {\n\nconstexpr int kTileK",
     "__device__ unsigned long long g_stamps[1 << 16];\n"
     "__device__ __forceinline__ unsigned long long now() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
     "#define STAMP(i) if (threadIdx.x == 0) g_stamps[(blockIdx.x + gridDim.x * "
     "(blockIdx.y + gridDim.y * blockIdx.z)) * 8 + (i)] = (i) ? now() : "
     "[] { unsigned s; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s)); return s; }()\n"
     "namespace {\n\nconstexpr int kTileK"),
    ("  const int nt = (kt_end - kt0 + S - 1) / S;            // stages\n",
     "  const int nt = (kt_end - kt0 + S - 1) / S;            // stages\n"
     "  STAMP(0); STAMP(1);\n"),
    ("  for (int it = 0; it < nt; ++it) {\n",
     "  STAMP(2);\n  for (int it = 0; it < nt; ++it) {\n"),
    ("                      // every thread is done with the stage refilled next\n",
     "                      // every thread is done with the stage refilled next\n"
     "    if (it == 0) STAMP(3);\n"),
    ("  ptx::cp_async_wait<0>();\n\n", "  ptx::cp_async_wait<0>();\n  STAMP(4);\n\n"),
    ("    return;\n  }\n  // the partial tile into", "    STAMP(7);\n    return;\n  }\n"
     "  // the partial tile into"),
    ("  ptx::cluster_sync();\n  // every read", "  ptx::cluster_sync();\n  STAMP(5);\n"
     "  // every read"),
    ("  ptx::cluster_sync();  // no block leaves while another reads its partials\n}\n",
     "  STAMP(6);\n  ptx::cluster_sync();  // no block leaves while another reads its partials\n"
     "  STAMP(7);\n}\n"),
    ('extern "C" int muxq_gemm_launch(',
     'extern "C" int muxq_gemm_stamps(void* dst, int n) {\n'
     '  const cudaError_t e = cudaMemcpyFromSymbol(dst, g_stamps, n * 8);\n'
     '  void* p;\n'
     '  cudaGetSymbolAddress(&p, g_stamps);\n'
     '  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, n * 8));\n}\n'
     'extern "C" int muxq_gemm_launch('),
)


def timeline(dev, gen, flush, card, report):
    d = OUT / "timeline"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    src = d / "muxq_gemm.cu"
    text = src.read_text()
    for old, new in TIMELINE_EDITS:
        if old not in text:
            raise RuntimeError(f"muxq_gemm.cu no longer holds {old[:50]!r}")
        text = text.replace(old, new)
    src.write_text(text)
    lib = d / "libmuxq_gemm.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for the timeline copy:\n{r.stdout}{r.stderr}")
    so = ctypes.CDLL(str(lib))
    fn = so.muxq_gemm_launch
    fn.argtypes = build.SIGNATURES["muxq_gemm"]
    fn.restype = ctypes.c_int
    so.muxq_gemm_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    current = build.launcher("muxq_gemm")
    build._LAUNCHERS["muxq_gemm"] = fn
    try:
        for site, m in (("gpt2 attn_out", 4), ("gpt2 mlp_up", 4), ("qwen2 mlp_up", 4),
                        ("qwen2 mlp_down", 4), ("gpt2 mlp_up", 64), ("gpt2 mlp_up", 128)):
            k, n = SITES[site]
            o = gemm_operands(k, n, m, gen, dev)
            rows, _, split_tiles, n_splits = gemm_plan(m, n, k, build.sm_count(dev))
            blocks = -(-n // 64) * n_splits * -(-m // rows)
            runs = []
            for _ in range(5):
                flush.sum()
                torch.cuda.synchronize()
                G.muxq_gemm(o["x"], o["w_km"], o["bs"], o["sx"], o["sw"], bk=512)
                torch.cuda.synchronize()
                st = torch.zeros(blocks * 8, dtype=torch.int64)
                if so.muxq_gemm_stamps(st.data_ptr(), blocks * 8):
                    raise RuntimeError("reading the stamps failed")
                st = st.view(blocks, 8).double()
                # a stamp a block did not reach (one split: no cluster
                # phases) is 0: its time goes to the next phase it reached
                t = torch.where(st[:, 1:] > 0, st[:, 1:] - st[:, 1].min(),
                                torch.full_like(st[:, 1:], float("nan")))
                runs.append(t)
            t = torch.stack(runs).nanmedian(0).values / 1e3   # us, median of runs
            sms = len(set(int(s) for s in st[:, 0]))
            last = t[:, 0].clone()
            rows = {}
            for i, name in enumerate(PHASES[1:], 1):
                d_ = t[:, i] - last
                last = torch.where(torch.isnan(t[:, i]), last, t[:, i])
                ok = ~torch.isnan(d_)
                if ok.any():
                    rows[name] = (float(d_[ok].median()), float(d_[ok].max()))
            row = {"site": site, "m": m, "split": (split_tiles, n_splits),
                   "blocks": blocks, "sms": sms,
                   "last_start_us": float(t[:, 0].max()),
                   "end_us": float(t[:, -1].max()), "phases_us": rows}
            report.setdefault("timeline", []).append(row)
            print(f"timeline {site} M={m} split {(split_tiles, n_splits)} {blocks} blocks "
                  f"on {sms} SMs: last start {row['last_start_us']:.2f} us, last end "
                  f"{row['end_us']:.2f} us; " + "; ".join(
                      f"{k_} {a:.2f}/{b:.2f}" for k_, (a, b) in rows.items())
                  + f" (median/max us)  [{card}]", flush=True)
    finally:
        build._LAUNCHERS["muxq_gemm"] = current


def gemm_operands(k, n, m, gen, dev):
    """Random int8 operands with a 2^3 first K-block; the weight both
    k-major (the current kernel's) and n-major (the earlier one's)."""
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    bs = torch.ones(k // 512, dtype=torch.int32)
    bs[0] = 8
    x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    sx = torch.rand(m, 1, generator=gen) * 0.1
    sw = torch.rand(1, n, generator=gen) * 0.1
    return {"x": x.to(dev), "w_km": w.T.contiguous().to(dev).T,
            "w_nm": w.to(dev), "bs": bs.to(dev), "sx": sx.to(dev),
            "sw": sw.to(dev)}


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = CS.smi_line()
    print(f"card: {card}", flush=True)
    build.build(["muxq_gemm", "rowwise_quantize"])
    earlier = None
    if args[:1] == ["compare"]:
        earlier = build_earlier(Path(args[1]))
        args = args[2:]
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    report = {"card": card, "gemm": [], "quantize": []}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    if earlier is not None:
        for site, (k, n) in SITES.items():
            for m in GEMM_M:
                o = gemm_operands(k, n, m, gen, dev)
                plain = G.muxq_gemm_plain(o["x"], o["w_nm"], o["bs"], o["sx"],
                                          o["sw"], 512)

                def cur(o=o):
                    return G.muxq_gemm(o["x"], o["w_km"], o["bs"], o["sx"],
                                       o["sw"], bk=512)

                out = torch.empty(m, n, device=dev)

                def old(o=o, out=out):
                    build.check(earlier["muxq_gemm"](
                        o["x"].data_ptr(), o["w_nm"].data_ptr(),
                        o["bs"].data_ptr(), o["sx"].data_ptr(),
                        o["sw"].data_ptr(), out.data_ptr(), m, n, k, 512,
                        stream()), "earlier muxq_gemm")
                    return out

                for label, fn in (("earlier", old), ("current", cur)):
                    if not torch.equal(fn(), plain):
                        raise AssertionError(f"{label} muxq_gemm {site} M={m} "
                                             "differs from the plain version")
                runs = {"earlier": [], "current": []}
                for label, fn in (("earlier", old), ("current", cur),
                                  ("current", cur), ("earlier", old)):
                    runs[label].append(CS.time_ms(torch, fn, flush))
                warm = CS.time_ms(torch, cur, None)[0]
                xp = CS.padded_rows(o["x"])   # padded once, outside the timed call
                int_mm = CS.maybe_time(torch, lambda o=o, xp=xp: torch._int_mm(
                    xp, o["w_km"]), flush)
                bnd = CS.bound(m * k + k * n + 4 * (k // 512 + m + n) + 4 * m * n,
                               2 * m * n * k, CS.INT8_OPS_S)
                row = {"site": site, "m": m, "k_pad": k, "n": n,
                       "split": gemm_plan(m, n, k, build.sm_count(dev))[2:],
                       "current": runs["current"], "earlier": runs["earlier"],
                       "current_warm_ms": warm, "int_mm_ms": int_mm,
                       "bound_ms": bnd[0], "bound_by": bnd[1]}
                report["gemm"].append(row)
                fmt = lambda rs: ", ".join(  # noqa: E731
                    f"{a:.4f} [{s[0]:.4f}-{s[1]:.4f}]" for a, s in rs)
                print(f"gemm {site} M={m} K_pad={k} N={n} split {row['split']}: "
                      f"current {fmt(runs['current'])} (warm {warm:.4f}); "
                      f"earlier {fmt(runs['earlier'])}; _int_mm {int_mm}; bound "
                      f"{bnd[0]:.5f} ({bnd[1]})  [{card}]", flush=True)

        for site, k_in in QUANT.items():
            w = torch.randn(k_in, 4, generator=gen).numpy()
            mask = torch.zeros(k_in, dtype=torch.bool)
            mask[torch.randperm(k_in, generator=gen)[:8]] = True
            mw = ops.prepare_weights(w, mask.numpy(), 3, bk=512)
            gi, isc = mw.gather_idx.to(dev), mw.in_scale.to(dev)
            k_pad = gi.shape[0]
            for m in QUANT_M:
                x = torch.randn(m, k_in, generator=gen).to(dev)
                x[:, mask.to(dev)] *= 40.0
                qp, sp = RQ.rowwise_quantize_plain(x, 8, gi, isc)

                def cur(x=x, gi=gi, isc=isc):
                    return RQ.rowwise_quantize(x, 8, gather_idx=gi, in_scale=isc)

                q = torch.empty(m, k_pad, dtype=torch.int8, device=dev)
                s = torch.empty(m, 1, device=dev)

                def old(x=x, gi=gi, isc=isc, q=q, s=s, m=m, k_in=k_in, k_pad=k_pad):
                    build.check(earlier["rowwise_quantize"](
                        x.data_ptr(), gi.data_ptr(), isc.data_ptr(), q.data_ptr(),
                        s.data_ptr(), m, k_in, k_pad, 127, 0, stream()),
                        "earlier rowwise_quantize")
                    return q, s

                for label, fn in (("earlier", old), ("current", cur)):
                    qk, sk = fn()
                    if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                        raise AssertionError(f"{label} rowwise_quantize {site} "
                                             f"M={m} differs from the plain version")
                runs = {"earlier": [], "current": []}
                for label, fn in (("earlier", old), ("current", cur),
                                  ("current", cur), ("earlier", old)):
                    runs[label].append(CS.time_ms(torch, fn, flush))
                warm = CS.time_ms(torch, cur, None)[0]
                bnd = CS.bound(m * k_in * 4 + k_pad * 8 + m * k_pad + m * 4,
                               4 * m * k_pad, CS.F32_FLOPS_S)
                row = {"site": site, "m": m, "k_in": k_in, "k_pad": k_pad,
                       "current": runs["current"], "earlier": runs["earlier"],
                       "current_warm_ms": warm, "bound_ms": bnd[0]}
                report["quantize"].append(row)
                fmt = lambda rs: ", ".join(  # noqa: E731
                    f"{a:.4f} [{s_[0]:.4f}-{s_[1]:.4f}]" for a, s_ in rs)
                print(f"quantize {site} x [{m}, {k_in}] -> [{m}, {k_pad}]: current "
                      f"{fmt(runs['current'])} (warm {warm:.4f}); earlier "
                      f"{fmt(runs['earlier'])}; bound {bnd[0]:.6f}  [{card}]",
                      flush=True)

    only = next((a.split("=", 1)[1].split(",") for a in args
                 if a.startswith("variants=")), None)
    if only is not None:
        VARIANTS["muxq_gemm"] = {k_: v for k_, v in VARIANTS["muxq_gemm"].items()
                                 if k_ in only}
        VARIANTS["rowwise_quantize"] = {}
        args.append("variants")
    if "variants" in args:
        current = {k_: build.launcher(k_) for k_ in VARIANTS}
        built = build_variants({(k_, name): subs for k_, vs in VARIANTS.items()
                                for name, subs in vs.items()})
        cases = []
        for site, k_in in QUANT.items():
            mw = ops.prepare_weights(torch.randn(k_in, 4, generator=gen).numpy(),
                                     (torch.arange(k_in) < 8).numpy(), 3, bk=512)
            gi, isc = mw.gather_idx.to(dev), mw.in_scale.to(dev)
            x = torch.randn(4, k_in, generator=gen).to(dev)
            qp = RQ.rowwise_quantize_plain(x, 8, gi, isc)
            cases.append(("rowwise_quantize", f"{site} M=4", qp,
                          lambda x=x, gi=gi, isc=isc: RQ.rowwise_quantize(
                              x, 8, gather_idx=gi, in_scale=isc)))
        for site, (k, n) in SITES.items():
            for m in (4, 64, 128):
                o = gemm_operands(k, n, m, gen, dev)
                yp = G.muxq_gemm_plain(o["x"], o["w_nm"], o["bs"], o["sx"], o["sw"], 512)
                cases.append(("muxq_gemm", f"{site} M={m}", (yp,),
                              lambda o=o: (G.muxq_gemm(o["x"], o["w_km"], o["bs"],
                                                       o["sx"], o["sw"], bk=512),)))
        for kernel, label, want, fn in cases:
            times = {}
            for name in ("current", *VARIANTS[kernel], "current"):
                build._LAUNCHERS[kernel] = (current[kernel] if name == "current"
                                            else built[(kernel, name)][0])
                got = fn()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{kernel} variant {name!r} {label} differs "
                                         "from the plain version")
                times.setdefault(name, []).append(CS.time_ms(torch, fn, flush)[0])
            build._LAUNCHERS[kernel] = current[kernel]
            report.setdefault("variants", []).append(
                {"kernel": kernel, "case": label, "ms": times})
            print(f"variants {kernel} {label}: " + "; ".join(
                f"{name} " + "/".join(f"{v:.4f}" for v in vs)
                for name, vs in times.items()) + f"  [{card}]", flush=True)

    if "breakdown" in args:
        built = build_variants({("muxq_gemm", k_): v for k_, v in BREAKDOWN.items()})
        current = build.launcher("muxq_gemm")
        for site in ("gpt2 attn_out", "gpt2 mlp_up", "qwen2 mlp_up", "qwen2 mlp_down"):
            k, n = SITES[site]
            for m in (4, 64, 128):
                o = gemm_operands(k, n, m, gen, dev)
                times = {}
                for name in ("current", *BREAKDOWN):
                    build._LAUNCHERS["muxq_gemm"] = (current if name == "current"
                                                     else built[("muxq_gemm", name)][0])
                    times[name] = CS.time_ms(torch, lambda o=o: G.muxq_gemm(
                        o["x"], o["w_km"], o["bs"], o["sx"], o["sw"], bk=512), flush)[0]
                build._LAUNCHERS["muxq_gemm"] = current
                report.setdefault("breakdown", []).append(
                    {"site": site, "m": m, "ms": times})
                print(f"breakdown {site} M={m}: " + "; ".join(
                    f"{k_} {v:.4f}" for k_, v in times.items()) + f"  [{card}]", flush=True)

    if "timeline" in args:
        timeline(dev, gen, flush, card, report)

    if "profile" in args:
        from torch.profiler import ProfilerActivity, profile
        for label, fn in (("empty kernel", lambda: torch.cuda._sleep(0)),
                          ("one-element fill", lambda b=torch.zeros(1, device=dev):
                           b.fill_(1.0))):
            cold, spread = CS.time_ms(torch, fn, flush)
            warm = CS.time_ms(torch, fn, None)[0]
            report.setdefault("floor", {})[label] = {"ms": cold, "warm_ms": warm}
            print(f"floor {label}: {cold:.4f} [{spread[0]:.4f}-{spread[1]:.4f}] "
                  f"(warm {warm:.4f})  [{card}]", flush=True)
        cases = []
        for site in ("gpt2 attn_out", "gpt2 mlp_up", "qwen2 mlp_up", "qwen2 mlp_down"):
            k, n = SITES[site]
            for m in (4, 20, 64, 128):
                o = gemm_operands(k, n, m, gen, dev)
                cases.append((f"muxq_gemm {site} M={m}", lambda o=o: G.muxq_gemm(
                    o["x"], o["w_km"], o["bs"], o["sx"], o["sw"], bk=512)))
        for site in ("gpt2 mlp_up", "qwen2 mlp_down"):
            k_in = QUANT[site]
            mw = ops.prepare_weights(torch.randn(k_in, 4, generator=gen).numpy(),
                                     (torch.arange(k_in) < 8).numpy(), 3, bk=512)
            gi, isc = mw.gather_idx.to(dev), mw.in_scale.to(dev)
            for m in (4, 64):
                x = torch.randn(m, k_in, generator=gen).to(dev)
                cases.append((f"rowwise_quantize {site} M={m}",
                              lambda x=x, gi=gi, isc=isc: RQ.rowwise_quantize(
                                  x, 8, gather_idx=gi, in_scale=isc)))
                cases.append((f"rowwise_quantize {site} M={m} unfused",
                              lambda x=x: RQ.rowwise_quantize(x, 8)))
        for label, fn in cases:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / max(e.count, 1))
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0]
            report.setdefault("profile", []).append({"case": label, "kernels_us": rows})
            print(f"profile {label}: " + "; ".join(f"{k_[:40]} {us:.2f} us"
                                                   for k_, us in rows)
                  + f"  [{card}]", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gemm_probe.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
