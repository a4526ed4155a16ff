#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero; each prints
its seconds):

1. Print the card's name and power limit (``nvidia-smi``) and build the
   four hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
2. Hold every kernel against its plain PyTorch version on the card:
   ``rowwise_quantize`` and ``muxq_gemm`` bit for bit at gpt2-small's
   sites (M 1/4/20/64/128) and qwen2-0.5b's widths (M 4/20/32/64/128), the
   weights k-major as served; ``paged_attention`` on fp, int8 and int4 pages (int4 at
   sq in {1, 4, 32} x g in {1, 7}, f32 and bf16 q, ragged tables with
   scratch page 0, a non-identity redistribution row); ``flash_attention``
   at b 1, s 2048, h 14, kv 2, dh 64 (causal, f32 and bf16, and a
   window-and-softcap case).  Every tolerance is elementwise (see the
   constants below); a bf16 paged case is also held, one bf16 ulp wide,
   against its f32 twin (the plain version in f32 on the kernel's own
   bf16-rounded operands).
3. Time each kernel (CUDA-graph replay after an L2 eviction; the median
   of 5 sets of replays, with their spread, after the clock is warmed),
   its plain version and a PyTorch yardstick beside the kernel's lower
   bound on this card, at the shapes the serving runs give it: decode,
   verify and prefill chunks on the page modes they use.
4. Serve gpt2-small at full width (12 layers, random weights from a seed,
   int8 pages): calibrate, pack the fused MUXQ kernel buffers, serve 4
   requests x 16 tokens, time ``muxq_gemm`` at each distinct site shape
   of the served artifact (its own weights; decode and prefill M, beside
   ``torch._int_mm``) and ``rowwise_quantize`` at the widest K, profile a
   repeat run, and hold the kernel path's logits against the plain
   path's.
5. Serve qwen2-0.5b at full width (24 layers, d 896, 14/2 heads, d_ff
   4864, vocab 151936; random weights with planted activation and KV
   outliers): calibrate through the port's dense ``forward`` (matmul
   sites and KV channels) and build the artifact with ``kv_calib``; hold
   the verify step's logits on int4 pages with the paged kernel against
   its plain version in place (with fp weights at 1e-3 of the logit scale;
   with the fused MUXQ ctx against the spread that one-ulp nudges of the
   plain attention make); then, on the same weights with the residual
   branches scaled down (so that the greedy stream repeats and n-gram
   drafts match), serve 4 repetitive requests x 16 tokens on int4 pages
   with speculation (k = 4) -- at least one draft rejected, one prompt
   repeated so that its pages are shared and copied on write -- time the
   served artifact's GEMM shapes at decode, verify (4 slots x 5 rows) and
   prefill M, and the quantize at the widest K, as for gpt2 -- and the
   same requests on f32 pages without speculation for comparison.
6. Print one JSON line with every kernel's numbers, the ``nvidia-smi``
   line, and the final ``{"ok": true, "device": ...}`` line.

``launches`` in the JSON line counts the launches of the serving runs of
phases 4 and 5 (each run starts from zero counts); ``flash_attention`` is
on no serving path and has 0.  It imports nothing of JAX or of the
reference package.  Details of every measurement also go to
``chip_smoke.json`` in the output directory at the root of the checkout
(``out_dir`` below, listed in ``.gitignore``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, int8 tensor-core ops/s,
# bf16 tensor-core flop/s, float32 (non-tensor-core) flop/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12
TIMING_SETS = 5     # time_ms: median over this many sets of replays
INT_MM_ROWS = 32    # the int8 yardstick's rows at decode M (it wants M > 16)
SLEEP_CYCLES = 200_000  # time_ms: a busy wait ahead of each timed replay

# tolerances, elementwise: |kernel - reference| <= atol + rtol * |reference|
BF16_ULP = 2.0 ** -7    # rtol of every bf16 case: one bf16 ulp of the element
TWIN_ATOL = 1e-4        # bf16 q, against the f32 twin (the plain version in
                        # f32 on the kernel's own bf16-rounded operands): only
                        # f32 summation order and the output rounding differ.
# bf16 q against the plain version, which rounds scores and probabilities to
# bf16 (the kernel keeps them f32): atol = TWIN_ATOL + (1 + 2^-7) |twin -
# plain|, the plain version's own rounding error at that element
FP_PAGED_MAX = 2e-2     # bf16 fp pages: max abs err vs plain (also elementwise)
F32_ATOL = 1e-4     # f32 paged attention: only the summation order differs
FLASH_F32_ATOL = 2e-4   # f32 flash attention over 2048 keys (sum order); bf16
                        # flash: the plain version is f32 math rounded to bf16,
                        # so the same atol plus one bf16 ulp
SERVE_BRANCH_SCALE = 2e-3   # qwen2's served weights: attention and MLP
                            # output projections scaled down (phase 5)
VERIFY_RTOL = 1e-3  # in-situ verify logits on int4 pages with fp weights,
                    # paged kernel vs plain, relative to max |logits|: the
                    # attention sums' order differs, and an ulp may move an
                    # int4 K/V code
NUDGE_FACTOR = 2.0  # in-situ verify logits under fused MUXQ, kernel vs plain:
                    # at most this x the plain-vs-plain spread that 1-ulp
                    # nudges of every attention output make


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, flush, iters: int = 20):
    """Device time of ``fn``: the median, over TIMING_SETS sets of
    ``iters`` runs, of a set's mean run, and the spread (min, max) of the
    set means.  Each run follows a read of a 64 MB buffer that evicts L2
    (the serving path finds weights cold: the layers' weights exceed the
    50 MB L2); ``flush=None`` times it warm.  ``fn`` is captured once in a
    CUDA graph and replayed, so the events time the device work and not
    the Python and launch overhead between ops (``call_ms`` measures
    that); a sleep kernel ahead of the start event keeps the stream busy
    while the host enqueues the events and the replay, so the host's
    launch latency stays outside them.  Replays for at least 50 ms first
    warm the clock."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize()
    means = []
    for _ in range(TIMING_SETS):
        total = 0.0
        for _ in range(iters):
            if flush is not None:
                flush.sum()     # a read leaves L2 full of clean, unrelated lines
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        means.append(total / iters)
    return sorted(means)[len(means) // 2], (min(means), max(means))


def call_ms(torch, fn, iters: int = 50) -> float:
    """Mean wall time of one eager call, synchronized: device time plus
    the host's Python and launch overhead, as the eager serving loop pays
    it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def padded_rows(x):
    """X zero-padded to INT_MM_ROWS rows: ``torch._int_mm`` wants M > 16."""
    if x.shape[0] >= INT_MM_ROWS:
        return x
    out = x.new_zeros(INT_MM_ROWS, x.shape[1])
    out[: x.shape[0]] = x
    return out


def maybe_time(torch, fn, flush):
    """The median ``time_ms`` of a library yardstick, or None where the
    library call refuses these inputs (``torch._int_mm`` wants M > 16, for
    one)."""
    try:
        fn()
    except RuntimeError as e:
        print(f"yardstick refused: {str(e).splitlines()[0]}")
        return None
    return time_ms(torch, fn, flush)[0]


class Phases:
    """Prints and records each phase's wall seconds."""

    def __init__(self, report):
        self.report, self.t0 = report, time.perf_counter()
        report["phase_s"] = {}

    def done(self, name: str) -> None:
        t = time.perf_counter()
        self.report["phase_s"][name] = t - self.t0
        print(f"phase {name}: {t - self.t0:.1f} s", flush=True)
        self.t0 = t


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.context import CollectCtx, FpCtx, as_ctx
    from repro_torch.core.muxq import QuantConfig
    from repro_torch.core.policy import SitePolicy
    from repro_torch.kernels import build, dispatch, ops
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quantize as RQ
    from repro_torch.models import transformer as T
    from repro_torch.quantize import build_artifact, calibrate_model
    from repro_torch.serve import kvq
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.kvcache import quantize_kv
    from repro_torch.serve.pool import PagePool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks": [], "timings": []}
    phases = Phases(report)

    # -- 1. build -------------------------------------------------------------
    logs = build.build(verbose=True)
    print(f"build: {len(logs)} kernels", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    phases.done("build")

    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev)   # 64 MB
    cfg = get_config("gpt2-small")
    qcfg = get_config("qwen2-0.5b")
    d, f = cfg.d_model, cfg.d_ff
    sites = {"attn_qkv": (d, 3 * d), "attn_out": (d, d), "mlp_up": (d, f),
             "mlp_down": (f, d)}
    gen = torch.Generator().manual_seed(0)
    kern = {}

    def record(name, vs="plain", **kw):
        entry = {"kernel": name, "vs": vs, **kw}
        report["checks"].append(entry)
        kern.setdefault(name, {"max_abs_err": 0.0})
        if vs == "plain":
            kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"],
                                            float(kw.get("max_abs_err", 0.0)))

    def held(name, out, ref, atol, rtol=0.0, cap=None, vs="plain", **kw):
        """Elementwise |out - ref| <= atol + rtol * |ref| (``atol`` a number
        or a tensor of ref's shape), all finite; ``cap`` bounds the max abs
        error as well.  Records the max abs error and the largest share of
        its element's limit that any element uses."""
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        lim = atol + rtol * ref.float().abs()
        err = float(diff.max())
        ratio = float((diff / lim.clamp_min(1e-30)).max())
        atol_max = float(torch.as_tensor(atol).max())
        if not (torch.isfinite(out).all() and bool((diff <= lim).all())
                and (cap is None or err <= cap)):
            raise AssertionError(
                f"{name} {kw} vs {vs}: max abs err {err}, worst element at "
                f"{ratio:.3f} x its limit (atol {atol_max:.3g} max, rtol "
                f"{rtol}, cap {cap})")
        record(name, vs=vs, max_abs_err=err, max_ratio=ratio,
               atol_max=atol_max, rtol=rtol, cap=cap, **kw)
        return err

    def f32_twin(args, kw):
        """The plain version in f32 on the kernel's own operands for bf16 q:
        q upcast; pages dequantized in the plain version's order and rounded
        to bf16, as the kernel stages them, then passed as f32 fp pages.
        Returns the twin's output in bf16."""
        q, kp, vp, table, pos = args
        if "k_redist" in kw:
            kd, vd = ((kvq.unpack_int4(x).float() * kw[f"{n}_scale"].float()
                       * kw[f"{n}_redist"]) for x, n in ((kp, "k"), (vp, "v")))
        elif "k_scale" in kw:
            kd, vd = kp.float() * kw["k_scale"], vp.float() * kw["v_scale"]
        else:
            kd, vd = kp, vp
        kd, vd = (x.to(q.dtype).float() for x in (kd, vd))
        return PA.paged_attention_plain(q.float(), kd, vd, table,
                                        pos).to(q.dtype)

    def held_paged(name, args, kw, **tags):
        """The paged kernel against its plain version (and, for bf16 q, its
        f32 twin as well), with each case's stated tolerance."""
        out = PA.paged_attention_decode(*args, **kw)
        plain = PA.paged_attention_plain(*args, **kw)
        if args[0].dtype == torch.float32:
            return held(name, out, plain, F32_ATOL, **tags)
        twin = f32_twin(args, kw)
        held(name, out, twin, TWIN_ATOL, BF16_ULP, vs="f32 twin", **tags)
        own = (twin.float() - plain.float()).abs()
        return held(name, out, plain, TWIN_ATOL + (1 + BF16_ULP) * own,
                    BF16_ULP, cap=FP_PAGED_MAX if "[fp]" in name else None,
                    **tags)

    def served(mw):
        """A site's buffers on the card as the serving path holds them
        (``dispatch.buffer_to``: the weight k-major)."""
        return dispatch.as_muxq_weights(dispatch.buffer_to(
            {fld: getattr(mw, fld).numpy() for fld in dispatch.BUFFER_FIELDS},
            dev))

    # -- 2. kernels against their plain versions -------------------------------
    # an outlier run of 8 channels at e = 3: one 512-wide x8 K-block
    packed = {}
    for site, (k, n) in sites.items():
        w = torch.randn(k, n, generator=gen)
        mask = np.zeros(k, bool)
        mask[torch.randperm(k, generator=gen)[:8].numpy()] = True
        mw = ops.prepare_weights(w, mask, 3, bk=512)
        assert int(mw.block_scale[0]) == 8 and mw.n_out == 8
        packed[site] = (mask, served(mw))
    for site, (k, n) in sites.items():
        mask, mw = packed[site]
        k_pad = mw.w_int.shape[0]
        for m in (1, 4, 20, 64, 128):
            for dtype in ((torch.float32, torch.bfloat16) if m == 4
                          else (torch.float32,)):
                x = torch.randn(m, k, generator=gen)
                x[:, torch.from_numpy(mask)] *= 40.0
                x = x.to(dev, dtype)
                qk, sk = RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                             in_scale=mw.in_scale)
                qp, sp = RQ.rowwise_quantize_plain(x, 8, mw.gather_idx,
                                                   mw.in_scale)
                torch.cuda.synchronize()
                if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                    raise AssertionError(f"rowwise_quantize {site} m={m} "
                                         f"{dtype}: codes or scales differ")
                record("rowwise_quantize", site=site, m=m, k=k, k_pad=k_pad,
                       dtype=str(dtype), max_abs_err=0.0)
            yk = G.muxq_gemm(qk, mw.w_int, mw.block_scale, sk, mw.sw, bk=mw.bk)
            yp = G.muxq_gemm_plain(qk, mw.w_int, mw.block_scale, sk, mw.sw, mw.bk)
            torch.cuda.synchronize()
            if not torch.equal(yk, yp):
                err = float((yk - yp).abs().max())
                raise AssertionError(f"muxq_gemm {site} m={m}: not bit-equal "
                                     f"(max abs err {err})")
            record("muxq_gemm", site=site, m=m, k_pad=k_pad, n=n, max_abs_err=0.0)
    # qwen2's widths (K 896 and 4864, N 1152 / 896 / 9728) through both kernels
    for k, n in ((896, 1152), (896, 896), (896, 9728), (4864, 896)):
        w = torch.randn(k, n, generator=gen)
        mask = np.zeros(k, bool)
        mask[torch.randperm(k, generator=gen)[:6].numpy()] = True
        mw = served(ops.prepare_weights(w, mask, 2, bk=512))
        for m in (4, 20, 32, 64, 128):
            x = torch.randn(m, k, generator=gen)
            x[:, torch.from_numpy(mask)] *= 40.0
            x = x.to(dev)
            qk, sk = RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                         in_scale=mw.in_scale)
            qp, sp = RQ.rowwise_quantize_plain(x, 8, mw.gather_idx, mw.in_scale)
            yk = G.muxq_gemm(qk, mw.w_int, mw.block_scale, sk, mw.sw, bk=mw.bk)
            yp = G.muxq_gemm_plain(qk, mw.w_int, mw.block_scale, sk, mw.sw, mw.bk)
            torch.cuda.synchronize()
            if not (torch.equal(qk, qp) and torch.equal(sk, sp)
                    and torch.equal(yk, yp)):
                raise AssertionError(f"qwen2 width k={k} n={n} m={m}: kernels "
                                     "differ from their plain versions")
            record("muxq_gemm", site=f"qwen2 {k}x{n}", m=m, max_abs_err=0.0)
    print("kernel check: rowwise_quantize and muxq_gemm bit-exact at "
          f"{len(sites)} gpt2 sites x M in (1, 4, 20, 64, 128) and 4 qwen2 "
          "widths x M in (4, 20, 32, 64, 128)", flush=True)

    h, dh, ps = cfg.n_heads, cfg.head_dim, 16
    b, n_tab = 4, 8
    n_pages = b * n_tab + 1

    def ragged(sq):
        # ragged tables: full, short (tail -> scratch page 0), one page, idle
        table = torch.zeros(b, n_tab, dtype=torch.int32)
        table[0] = torch.arange(1, 1 + n_tab)
        table[1, :3] = torch.arange(9, 12)
        table[2, :1] = 17
        pos = torch.tensor([n_tab * ps - sq, 3 * ps - sq, 0, 0],
                           dtype=torch.int32)
        return table.to(dev), pos.to(dev)

    def paged_case(sq, mode, seed, *, heads=h, kvh=h, qdt=None):
        g2 = torch.Generator().manual_seed(seed)
        qdt = qdt or (torch.bfloat16 if mode == "fp" else torch.float32)
        q = torch.randn(b, sq, heads, dh, generator=g2).to(dev, qdt)
        k = torch.randn(n_pages, ps, kvh, dh, generator=g2).to(dev)
        v = torch.randn(n_pages, ps, kvh, dh, generator=g2).to(dev)
        table, pos = ragged(sq)
        kw = {}
        if mode == "int8":
            parts = quantize_kv(k, v)
            k, v = parts["k"], parts["v"]
            kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
        elif mode == "int4":
            # a non-identity redistribution row: 2^2 on two channels per head
            hot_k, hot_v = 5, dh // 2 + 5
            mask = np.zeros((kvh, dh), bool)
            mask[:, [hot_k, hot_v]] = True
            redist = torch.from_numpy(kvq.redist_from_mask(mask)).to(dev)
            k[..., hot_k] *= 8.0
            v[..., hot_v] *= 8.0
            parts = kvq.Int4KVQuantizer(redist, redist).quantize(k, v)
            k, v = parts["k"], parts["v"]
            kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"],
                  "k_redist": redist, "v_redist": redist}
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        return (q, k, v, table, pos), kw

    for mode in ("fp", "int8"):
        for sq in (1, 32):
            args, kw = paged_case(sq, mode, 10 * sq + len(mode))
            held_paged(f"paged_attention[{mode}]", args, kw, sq=sq)
    qkvh = qcfg.n_kv_heads
    for sq in (1, 4, 32):
        for g in (1, 7):
            for qdt in (torch.float32, torch.bfloat16):
                args, kw = paged_case(sq, "int4", 100 * sq + g, heads=g * qkvh,
                                      kvh=qkvh, qdt=qdt)
                held_paged("paged_attention[int4]", args, kw, sq=sq, g=g,
                           q=str(qdt))
    print("kernel check: paged_attention on fp (bf16), int8 and int4 pages "
          "(sq in 1/4/32, g in 1/7, f32 and bf16 q) within tolerance",
          flush=True)
    for c in report["checks"]:
        if c["kernel"].startswith("paged"):
            print(f"  {c['kernel']} {c.get('sq')}/{c.get('g', '-')}/"
                  f"{c.get('q', 'bf16' if c['kernel'].endswith('[fp]') else 'f32')}"
                  f" vs {c['vs']}: max abs err {c['max_abs_err']:.3g}, worst "
                  f"element at {c['max_ratio']:.3f} of its limit "
                  f"(atol max {c['atol_max']:.3g}, rtol {c['rtol']:.3g})")

    fb, fs, fh, fkv, fdh = 1, 2048, 14, 2, 64
    fg = torch.Generator().manual_seed(5)
    flash_in = {dt: tuple(torch.randn(fb, fs, n_h, fdh, generator=fg).to(dev, dt)
                          for n_h in (fh, fkv, fkv))
                for dt in (torch.float32, torch.bfloat16)}
    for dt, kw in ((torch.float32, dict(causal=True)),
                   (torch.bfloat16, dict(causal=True)),
                   (torch.float32, dict(causal=True, window=256, softcap=30.0))):
        fq, fk, fv = flash_in[dt]
        held("flash_attention", FA.flash_attention(fq, fk, fv, **kw),
             FA.flash_attention_plain(fq, fk, fv, **kw), FLASH_F32_ATOL,
             0.0 if dt == torch.float32 else BF16_ULP, dtype=str(dt), **kw)
    print("kernel check: flash_attention b 1 s 2048 h 14 kv 2 dh 64 causal "
          "(f32, bf16) and window 256 + softcap 30 within tolerance",
          flush=True)
    for c in report["checks"]:
        if c["kernel"] == "flash_attention":
            print(f"  flash_attention {c['dtype']} window {c.get('window')}: "
                  f"max abs err {c['max_abs_err']:.3g}, worst element at "
                  f"{c['max_ratio']:.3f} of its limit (atol {c['atol_max']:.3g},"
                  f" rtol {c['rtol']:.3g})")
    phases.done("kernel checks")

    # -- 3. timings at the serving shapes ---------------------------------------
    mask, mw = packed["mlp_up"]
    k, n = sites["mlp_up"]
    k_pad = mw.w_int.shape[0]
    m = 4
    x = torch.randn(m, k, generator=gen).to(dev)
    xq, sx = RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                 in_scale=mw.in_scale)
    xq_pad = padded_rows(xq)    # padded once, outside the timed call

    def rq_fn():
        return RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                   in_scale=mw.in_scale)

    timed = {}
    timed["rowwise_quantize"] = {
        "fn": rq_fn,
        "plain_ms": time_ms(torch, lambda: RQ.rowwise_quantize_plain(
            x, 8, mw.gather_idx, mw.in_scale), flush)[0],
        "library_ms": None,
        "shape": f"x [{m}, {k}] f32 -> int8 [{m}, {k_pad}] (gpt2 mlp_up)",
        **dict(zip(("bound_ms", "bound_by"), bound(
            m * k * 4 + k_pad * 8 + m * k_pad + m * 4, 4 * m * k_pad,
            F32_FLOPS_S)))}
    timed["muxq_gemm"] = {
        "fn": lambda: G.muxq_gemm(xq, mw.w_int, mw.block_scale, sx, mw.sw,
                                  bk=mw.bk),
        "plain_ms": time_ms(torch, lambda: G.muxq_gemm_plain(
            xq, mw.w_int, mw.block_scale, sx, mw.sw, mw.bk), flush)[0],
        "library_ms": maybe_time(torch, lambda: torch._int_mm(
            xq_pad, mw.w_int), flush),
        "shape": f"int8 [{m}, {k_pad}] x [{k_pad}, {n}] (gpt2 mlp_up; library: "
                 f"torch._int_mm on X zero-padded to {INT_MM_ROWS} rows)",
        **dict(zip(("bound_ms", "bound_by"), bound(
            m * k_pad + k_pad * n + 4 * (k_pad // mw.bk + m + n) + 4 * m * n,
            2 * m * n * k_pad, INT8_OPS_S)))}

    # the prefill GEMM (4 slots x a chunk of 32 rows) beside the int8
    # library GEMM
    xp = torch.randint(-127, 128, (128, k_pad), generator=gen,
                       dtype=torch.int8).to(dev)
    sxp = torch.rand(128, 1, generator=gen).to(dev)
    t128 = {"kernel": "muxq_gemm", "m": 128, "k_pad": k_pad, "n": n,
            "ms": time_ms(torch, lambda: G.muxq_gemm(
                xp, mw.w_int, mw.block_scale, sxp, mw.sw, bk=mw.bk), flush)[0],
            "int_mm_ms": maybe_time(torch, lambda: torch._int_mm(xp, mw.w_int),
                                    flush),
            "bound_ms": bound(128 * k_pad + k_pad * n + 4 * 128 * n,
                              2 * 128 * n * k_pad, INT8_OPS_S)[0]}
    report["timings"].append(t128)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    page_cost = {"fp": lambda ksz: 2 * dh * ksz, "int8": lambda ksz: 2 * (dh + 4),
                 "int4": lambda ksz: 2 * (dh // 2 + 2)}

    def paged_timing(mode, sq, heads, kvh, pos_list, label):
        """The paged kernel at a serving shape: one slot per entry of
        ``pos_list`` (its position), with 128-position tables; bound from
        the pages these positions read and the (query, key) pairs the
        causal mask allows."""
        (q, kp, vp, _, _), kw = paged_case(sq, mode, 7 + sq, heads=heads,
                                           kvh=kvh, qdt=torch.float32)
        if mode == "fp":
            kp, vp = kp.float(), vp.float()
        b = len(pos_list)
        q = q[:b].contiguous()
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        table = torch.arange(1, 1 + b * n_tab, dtype=torch.int32,
                             device=dev).reshape(b, n_tab)
        args = (q, kp, vp, table, pos)
        n_read = [min(n_tab, (p + sq - 1) // ps + 1) for p in pos_list]
        pairs = sum(p + i + 1 for p in pos_list for i in range(sq))
        nbytes = (sum(n_read) * ps * kvh * page_cost[mode](kp.element_size())
                  + 2 * q.numel() * 4 + table.numel() * 4 + 16
                  + (2 * kvh * dh * 4 if mode == "int4" else 0))
        # the yardstick: SDPA on the gathered, dequantized K/V, the KV heads
        # repeated to the query heads (gather, dequantization and repeat
        # are outside its time)
        if mode == "int4":
            qz = kvq.Int4KVQuantizer(kw["k_redist"], kw["v_redist"])
            kd, vd = qz.dequantize({"k": kp, "v": vp, "k_scale": kw["k_scale"],
                                    "v_scale": kw["v_scale"]}, torch.float32)
        elif mode == "int8":
            kd, vd = kp.float() * kw["k_scale"], vp.float() * kw["v_scale"]
        else:
            kd, vd = kp, vp
        kd = kd[table.long()].reshape(b, -1, kvh, dh).transpose(1, 2)
        vd = vd[table.long()].reshape(b, -1, kvh, dh).transpose(1, 2)
        kd = kd.repeat_interleave(heads // kvh, dim=1).contiguous()
        vd = vd.repeat_interleave(heads // kvh, dim=1).contiguous()
        kpos = torch.arange(kd.shape[2], device=dev)
        qpos = pos[:, None] + torch.arange(sq, device=dev)[None]
        allow = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        qs = q.transpose(1, 2)
        return {"fn": lambda: PA.paged_attention_decode(*args, **kw),
                "plain_ms": time_ms(torch, lambda: PA.paged_attention_plain(
                    *args, **kw), flush)[0],
                "library_ms": time_ms(torch, lambda: sdpa(
                    qs, kd, vd, attn_mask=allow), flush)[0],
                "shape": f"{label}: b={b} sq={sq} h={heads} kvh={kvh} dh={dh} "
                         f"{mode} pages, {sum(n_read) * ps} key positions read",
                **dict(zip(("bound_ms", "bound_by"), bound(
                    nbytes, 4 * dh * heads * pairs, F32_FLOPS_S)))}

    qh = qcfg.n_heads
    # decode step of the gpt2 serving run: 4 live slots, 128-position tables
    timed["paged_attention[int8]"] = paged_timing(
        "int8", 1, h, h, [127, 100, 64, 40], "gpt2 decode")
    timed["paged_attention[fp]"] = paged_timing(
        "fp", 1, qh, qkvh, [127, 100, 64, 40], "qwen2 decode")
    timed["paged_attention[int4]"] = paged_timing(
        "int4", 1, qh, qkvh, [127, 100, 64, 40], "qwen2 decode")
    timed["paged_attention[int4] verify"] = paged_timing(
        "int4", 4, qh, qkvh, [124, 97, 61, 37], "qwen2 verify")
    timed["paged_attention[int4] prefill"] = paged_timing(
        "int4", 32, qh, qkvh, [96, 64, 32, 0], "qwen2 prefill chunk")
    # the prefill chunks of the gpt2 run (2 prompts at once) and of the
    # qwen2 run on f32 pages
    timed["paged_attention[int8] prefill"] = paged_timing(
        "int8", 32, h, h, [32, 0], "gpt2 prefill chunk")
    timed["paged_attention[fp] prefill"] = paged_timing(
        "fp", 32, qh, qkvh, [96, 64, 32, 0], "qwen2 prefill chunk")

    fq, fk, fv = flash_in[torch.bfloat16]
    pairs = fs * (fs + 1) // 2

    def heads_first(q_, k_, v_):
        """[b, s, heads, dh] -> SDPA's [b, heads, s, dh], KV heads repeated
        to the query heads (outside the yardstick's time)."""
        g_ = q_.shape[2] // k_.shape[2]
        return tuple(t.repeat_interleave(r, dim=2).transpose(1, 2).contiguous()
                     for t, r in ((q_, 1), (k_, g_), (v_, g_)))

    sq_in = {dt: heads_first(*flash_in[dt]) for dt in flash_in}
    timed["flash_attention"] = {
        "fn": lambda: FA.flash_attention(fq, fk, fv, causal=True),
        "plain_ms": time_ms(torch, lambda: FA.flash_attention_plain(
            fq, fk, fv, causal=True), flush)[0],
        "library_ms": time_ms(torch, lambda: sdpa(
            *sq_in[torch.bfloat16], is_causal=True), flush)[0],
        "shape": f"b={fb} s={fs} h={fh} kv={fkv} dh={fdh} causal bf16",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * (fq.numel() * 2 + fk.numel() + fv.numel()),
            4 * fb * fh * fdh * pairs, BF16_FLOPS_S)))}
    fq32, fk32, fv32 = flash_in[torch.float32]
    timed["flash_attention f32"] = {
        "fn": lambda: FA.flash_attention(fq32, fk32, fv32, causal=True),
        "plain_ms": time_ms(torch, lambda: FA.flash_attention_plain(
            fq32, fk32, fv32, causal=True), flush)[0],
        "library_ms": time_ms(torch, lambda: sdpa(
            *sq_in[torch.float32], is_causal=True), flush)[0],
        "shape": f"b={fb} s={fs} h={fh} kv={fkv} dh={fdh} causal f32",
        **dict(zip(("bound_ms", "bound_by"), bound(
            4 * (fq32.numel() * 2 + fk32.numel() + fv32.numel()),
            4 * fb * fh * fdh * pairs, F32_FLOPS_S)))}

    for name, t in timed.items():
        fn = t.pop("fn")
        t["ms"], t["spread_ms"] = time_ms(torch, fn, flush)
        t["warm_ms"], t["warm_spread_ms"] = time_ms(torch, fn, None)
        t["call_ms"] = call_ms(torch, fn, iters=10 if "flash" in name else 50)
        report["timings"].append({"kernel": name, **t})
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"time {name} [{t['shape']}]: kernel {t['ms']:.4f} ms (median "
              f"of {TIMING_SETS} sets, spread {t['spread_ms'][0]:.4f}-"
              f"{t['spread_ms'][1]:.4f}; warm L2 {t['warm_ms']:.4f} ms, eager "
              f"call {t['call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})  [{card}]", flush=True)
    print(f"time muxq_gemm [gpt2 mlp_up, prefill M=128]: kernel {t128['ms']:.4f} ms, torch._int_mm "
          f"{t128['int_mm_ms']} ms, bound {t128['bound_ms']:.4f} ms  [{card}]",
          flush=True)

    def time_sites(ctx, label, ms, k_widest):
        """``muxq_gemm`` at each distinct (K_pad, N) that a served
        artifact's sites run, on their own k-major weights on the card, at
        the M of the serve's steps; ``rowwise_quantize`` at the widest K
        (``mlp_down``'s input, ``k_widest`` channels, decode M).  Cold and
        warm (with the cold spread), the bound, and ``torch._int_mm`` on the
        same weight (X zero-padded to INT_MM_ROWS rows where M is smaller)."""
        shapes = {}
        for site, buf in sorted(ctx.kernel_buffers.items()):
            shapes.setdefault((site.split("/")[-1], *buf["w_int"].shape), site)
        for (base, k_pad, n), site in sorted(shapes.items()):
            smw = dispatch.as_muxq_weights(ctx.kernel_buffers[site])
            for m in ms:
                xs_ = torch.randint(-127, 128, (m, k_pad), generator=gen,
                                    dtype=torch.int8).to(dev)
                ss_ = torch.rand(m, 1, generator=gen).to(dev)

                def fn(xs_=xs_, ss_=ss_, smw=smw):
                    return G.muxq_gemm(xs_, smw.w_int, smw.block_scale, ss_,
                                       smw.sw, bk=smw.bk)
                row = {"kernel": "muxq_gemm", "model": label, "site": base,
                       "m": m, "k_pad": k_pad, "n": n}
                row["ms"], row["spread_ms"] = time_ms(torch, fn, flush)
                row["warm_ms"], _ = time_ms(torch, fn, None)
                xp_ = padded_rows(xs_)   # padded once, outside the timed call
                row["int_mm_ms"] = maybe_time(torch, lambda: torch._int_mm(
                    xp_, smw.w_int), flush)
                row["bound_ms"], row["bound_by"] = bound(
                    m * k_pad + k_pad * n + 4 * (k_pad // smw.bk + m + n)
                    + 4 * m * n, 2 * m * n * k_pad, INT8_OPS_S)
                report["timings"].append(row)
                print(f"time muxq_gemm [{label} {base} M={m} K_pad={k_pad} "
                      f"N={n}]: kernel {row['ms']:.4f} ms (spread "
                      f"{row['spread_ms'][0]:.4f}-{row['spread_ms'][1]:.4f}; "
                      f"warm {row['warm_ms']:.4f}), torch._int_mm "
                      f"{row['int_mm_ms']} ms (M padded to "
                      f"{max(m, INT_MM_ROWS)}), bound {row['bound_ms']:.5f} ms "
                      f"({row['bound_by']})  [{card}]", flush=True)
        site = next(s for s in sorted(ctx.kernel_buffers)
                    if s.endswith("mlp_down"))
        buf = ctx.kernel_buffers[site]
        k_pad = buf["gather_idx"].shape[0]
        xr = torch.randn(4, k_widest, generator=gen).to(dev)

        def rq(xr=xr, buf=buf):
            return RQ.rowwise_quantize(xr, 8, gather_idx=buf["gather_idx"],
                                       in_scale=buf["in_scale"])
        row = {"kernel": "rowwise_quantize", "model": label, "site": "mlp_down",
               "m": 4, "k_in": k_widest, "k_pad": k_pad}
        row["ms"], row["spread_ms"] = time_ms(torch, rq, flush)
        row["warm_ms"], _ = time_ms(torch, rq, None)
        row["bound_ms"], row["bound_by"] = bound(
            4 * k_widest * 4 + k_pad * 8 + 4 * k_pad + 16, 16 * k_pad,
            F32_FLOPS_S)
        report["timings"].append(row)
        print(f"time rowwise_quantize [{label} mlp_down x [4, {k_widest}] f32 -> "
              f"int8 [4, {k_pad}]]: kernel {row['ms']:.4f} ms (spread "
              f"{row['spread_ms'][0]:.4f}-{row['spread_ms'][1]:.4f}; warm "
              f"{row['warm_ms']:.4f}), bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})  [{card}]", flush=True)
    phases.done("timings")

    policy = SitePolicy.uniform(QuantConfig(
        method="muxq", outlier_mode="static", act_granularity="per_token",
        backend="fused", weight_granularity="per_channel"))

    def reset_counts():
        RQ.LAUNCHES = G.LAUNCHES = FA.LAUNCHES = 0
        for key in PA.MODE_LAUNCHES:
            PA.MODE_LAUNCHES[key] = 0

    def read_counts():
        return {"rowwise_quantize": RQ.LAUNCHES, "muxq_gemm": G.LAUNCHES,
                **{f"paged_attention[{key}]": c
                   for key, c in PA.MODE_LAUNCHES.items()},
                "flash_attention": FA.LAUNCHES}

    def serve(engine, prompts, max_new, label):
        """One main-path run: counts set to 0 just before, read just after."""
        reqs = [Request(p, max_new_tokens=max_new) for p in prompts]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        for r in reqs:
            if not r.done or not (len(r.out_tokens) == max_new
                                  or r.out_tokens[-1] == 257):
                raise AssertionError(f"{label}: request {r.prompt[:20]!r} "
                                     f"produced {len(r.out_tokens)} tokens")
        rep = engine.metrics.report()
        print(f"serve {label}: {rep['tokens_out']} tokens, "
              f"{rep['decode_steps']} decode steps ({rep['spec_verify_steps']} "
              f"verify), {rep['prefill_steps']} prefill steps in {secs:.3f} s "
              f"(host clock, eager, first run); launches {counts}  [{card}]",
              flush=True)
        return reqs, rep, counts, secs

    main_runs = {}

    # -- 4. end to end: gpt2-small at full width --------------------------------
    params = T.init_params(cfg, seed=0, device=dev)
    hot = torch.randperm(d, generator=torch.Generator().manual_seed(1))[:8].to(dev)
    for lp in params["layers"]:           # seeded outlier channels: a random
        lp["ln1"]["gain"][hot] *= 20.0    # net has none, and an empty mask
        lp["ln2"]["gain"][hot] *= 20.0    # never runs the 2^e blocks
    collect = CollectCtx()
    cal_pool = PagePool(cfg, 2, 64, page_size=ps, mode="fp",
                        dtype=torch.float32, device=dev)
    cal_table = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    zero2 = torch.zeros(2, dtype=torch.int32, device=dev)
    full2 = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for seed in (0, 1):
            toks = torch.randint(0, cfg.vocab_size, (2, 64),
                                 generator=torch.Generator().manual_seed(seed),
                                 dtype=torch.int32).to(dev)
            T.prefill_chunk_paged(cfg, params, toks, cal_pool.kv, cal_table,
                                  zero2, zero2, full2, collect)
    masks = collect.stats.masks()
    art = build_artifact(cfg, params, policy, masks)
    runs = {s: int((b_["block_scale"] > 1).sum())
            for s, b_ in art.kernel_buffers.items()}
    n_runs = sum(1 for r in runs.values() if r)
    print(f"gpt2 calibration: {len(masks)} sites, "
          f"{sum(int(m_.sum()) for m_ in masks.values())} outlier channels; "
          f"{n_runs} of {len(runs)} packed sites carry a 2^e block run",
          flush=True)
    if n_runs == 0:
        raise AssertionError("no packed site has a non-empty outlier run")

    engine = ServeEngine(cfg, art, max_batch=4, s_max=256, prefill_chunk=32,
                         kv_mode="int8", device=dev)
    prompts = ["The quantized model serves every request through paged "
               "attention on the card.",
               "Outlier channels are shifted down by a power of two.",
               "one int8 GEMM",
               "Chunked prefill interleaves with the pooled decode so that "
               "long prompts never stall the live slots of the pool."]
    _, rep, launches, serve_s = serve(engine, prompts, 16, "gpt2-small int8")
    for key in ("rowwise_quantize", "muxq_gemm", "paged_attention[int8]"):
        if launches[key] <= 0:
            raise AssertionError(f"gpt2 serve never launched {key}: {launches}")
    main_runs["gpt2-small int8"] = launches
    # decode (4 slots) and prefill GEMMs of this serve: a prefill step runs
    # one [4 slots, chunk] block, M 64 (chunk bucket 16) or 128 (32)
    time_sites(engine.ctx, "gpt2", (4, 64, 128), cfg.d_ff)
    report["serve"] = {"seconds": serve_s, "launches": launches,
                       "tokens_out": rep["tokens_out"],
                       "decode_steps": rep["decode_steps"],
                       "prefill_steps": rep["prefill_steps"],
                       "prefill_chunks": rep["prefill_chunks"],
                       "outlier_runs": runs}

    # where a serving step's time goes: the same 4 requests x 8 tokens twice,
    # first on the host clock alone, then under the profiler for the kernel
    # time.  The profiler slows the host, so the busy share is given against
    # both walls, per step: device time / (unprofiled or profiled) wall.
    from torch.profiler import ProfilerActivity, profile

    def serve_again():
        reqs_ = [Request(p, max_new_tokens=8) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs_)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(r.done and r.out_tokens for r in reqs_):
            raise AssertionError("a repeated request produced no tokens")
        return wall, engine.metrics.decode_steps + engine.metrics.prefill_steps

    wall_a, steps_a = serve_again()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_b, steps_b = serve_again()
    # kernel rows only: an aten op's row also carries its kernels' time
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_s = sum(t for _, t in rows) / 1e6
    top = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:8]
    busy = (dev_s / steps_b) / (wall_a / steps_a)
    report["profile"] = {
        "wall_s": wall_a, "steps": steps_a, "profiled_wall_s": wall_b,
        "profiled_steps": steps_b, "device_s": dev_s, "busy_share": busy,
        "profiled_busy_share": dev_s / wall_b,
        "top": [{"name": k[:80], "ms": t / 1e3} for k, t in top]}
    print(f"profile gpt2: {steps_a} steps in {wall_a:.3f} s wall ({steps_b} "
          f"steps in {wall_b:.3f} s under the profiler); device busy "
          f"{dev_s:.4f} s, {busy:.1%} of the unprofiled wall "
          f"({dev_s / wall_b:.1%} of the profiled); top kernels: "
          + "; ".join(f"{k[:40]} {t / 1e3:.2f} ms" for k, t in top[:4])
          + f"  [{card}]", flush=True)

    # logits on one 2-slot prefill chunk, kernel path vs plain path:
    #  (a) fused MUXQ kernels vs their plain versions, the paged kernel
    #      shared: every input identical, so the logits must be bit-equal;
    #  (b) the paged kernel vs its plain version on fp32 pages and fp
    #      weights: only the attention sums' order differs (tolerance 1e-3
    #      of the logit scale after 12 layers);
    #  (c) everything plain vs everything kernel on int8: reported only —
    #      an ulp of attention difference can flip an int8 activation code,
    #      and a random 12-layer net amplifies the flip.
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).to(dev)
    full32 = torch.full((2,), 32, dtype=torch.int32, device=dev)

    def chunk_logits(ctx, mode, fused="auto", paged="auto"):
        pool = PagePool(cfg, 2, 64, page_size=ps, mode=mode,
                        dtype=torch.float32, device=dev)
        prev = (dispatch.set_fused_impl(fused), PA.set_paged_impl(paged))
        try:
            with torch.no_grad():
                out, _ = T.prefill_chunk_paged(cfg, engine.params, toks, pool.kv,
                                               cal_table, zero2, zero2, full32,
                                               ctx)
        finally:
            dispatch.set_fused_impl(prev[0])
            PA.set_paged_impl(prev[1])
        return out[..., :cfg.vocab_size]

    lk = chunk_logits(engine.ctx, "int8")
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel-path logits are not finite")
    if not torch.equal(lk, chunk_logits(engine.ctx, "int8", fused="ref")):
        raise AssertionError("(a) fused kernels change the logits in situ")
    fk = chunk_logits(CollectCtx(), "fp")
    fp_ = chunk_logits(CollectCtx(), "fp", paged="ref")
    err_b = float((fk - fp_).abs().max())
    scale_b = float(fp_.abs().max())
    lp_ = chunk_logits(engine.ctx, "int8", fused="ref", paged="ref")
    err_c = float((lk - lp_).abs().max())
    agree = float((lk.argmax(-1) == lp_.argmax(-1)).float().mean())
    report["serve"].update(logits_fp_max_abs_err=err_b, logits_fp_scale=scale_b,
                           logits_int8_max_abs_err=err_c,
                           logits_int8_argmax_agreement=agree)
    print(f"logits gpt2: (a) fused kernels bit-equal in situ; (b) paged kernel "
          f"vs plain on fp32 pages max abs err {err_b:.3e} (|logits| max "
          f"{scale_b:.3f}); (c) all-kernel vs all-plain int8 max abs err "
          f"{err_c:.3e}, argmax agreement {agree:.3f}", flush=True)
    if err_b > 1e-3 * scale_b:
        raise AssertionError("(b) paged kernel logits disagree with the plain path")
    del engine, params, art, cal_pool
    torch.cuda.empty_cache()
    phases.done("serve gpt2-small")

    # -- 5. end to end: qwen2-0.5b at full width, int4 pages + speculation ------
    qdh = qcfg.head_dim
    k0 = qcfg.n_heads * qdh                 # K columns of wqkv start here
    k_hot = [k0 + 5, k0 + qdh * (qkvh - 1) + (qdh // 2 + 5) % qdh]
    qhot = torch.randperm(qcfg.d_model,
                          generator=torch.Generator().manual_seed(2))[:8].to(dev)
    cal_batches = [{"tokens": torch.randint(
        0, qcfg.vocab_size, (2, 64),
        generator=torch.Generator().manual_seed(10 + i)).numpy()}
        for i in range(2)]

    def qwen2_artifact(branch_scale, label):
        """Seeded qwen2 weights with planted outliers (8 RMSNorm gain
        channels x20, two K channels of wqkv x20), the attention and MLP
        output projections scaled by ``branch_scale``; calibrated through
        the dense forward and packed under the fused-MUXQ policy."""
        params_ = T.init_params(qcfg, seed=0, device=dev)
        for lp in params_["layers"]:
            lp["ln1"]["gain"][qhot] = 19.0      # RMSNorm (1 + gain): x20
            lp["ln2"]["gain"][qhot] = 19.0
            lp["attn"]["wqkv"][:, k_hot] *= 20.0   # KV outlier channels
            lp["attn"]["wo"] *= branch_scale
            lp["mlp"]["wo"] *= branch_scale
        stats_, calib_ = calibrate_model(qcfg, params_, cal_batches, device=dev)
        masks_ = stats_.masks()
        n_kv = int(calib_["k_mask"].sum() + calib_["v_mask"].sum())
        print(f"qwen2 calibration ({label}, dense forward): {len(masks_)} "
              f"sites, {sum(int(m_.sum()) for m_ in masks_.values())} "
              f"activation outlier channels; {n_kv} KV outlier channels "
              f"(k {calib_['k_mask'].sum()}, v {calib_['v_mask'].sum()} of "
              f"{2 * qkvh * qdh})", flush=True)
        if n_kv <= 0:
            raise AssertionError("calibration found no KV outlier channel")
        art_ = build_artifact(qcfg, params_, policy, masks_, kv_calib=calib_)
        if not any(int((b_["block_scale"] > 1).sum())
                   for b_ in art_.kernel_buffers.values()):
            raise AssertionError("no qwen2 packed site has a non-empty "
                                 "outlier run")
        return params_, art_, calib_, n_kv

    # the verify step in place, kernels vs plain paged version, on the
    # unscaled weights (attention moves the logits there): a 2-slot
    # 32-token prefill on int4 pages, then one k = 4 verify block (slot 1
    # crosses a page boundary), from the same pool state both times
    vparams, vart, vcalib, _ = qwen2_artifact(1.0, "unscaled")
    vctx = as_ctx(vart, dev)
    vpool = PagePool(qcfg, 2, 64, page_size=16, mode="int4", kv_calib=vcalib,
                     device=dev)
    vtab = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    vtoks = torch.randint(0, qcfg.vocab_size, (2, 32),
                          generator=torch.Generator().manual_seed(4),
                          dtype=torch.int32).to(dev)
    vlen = torch.tensor([32, 30], dtype=torch.int32, device=dev)
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.no_grad():
        T.prefill_chunk_paged(qcfg, vparams, vtoks, vpool.kv, vtab, zero,
                              zero, vlen, vctx)
    snapshot = {n_: a.clone() for n_, a in vpool.kv.items()}
    block = torch.randint(0, qcfg.vocab_size, (2, 4),
                          generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32).to(dev)
    n_valid = torch.tensor([4, 4], dtype=torch.int32, device=dev)

    def nudged(plain, seed):
        """The plain paged version with its output moved one f32 ulp up or
        down (a seeded coin per element): the size of difference that the
        kernel's summation order makes."""
        coin = torch.Generator(device=dev).manual_seed(seed)

        def fn(*a, **kw):
            out = plain(*a, **kw)
            up = torch.rand(out.shape, generator=coin, device=dev) < 0.5
            return torch.nextafter(out, torch.where(up, float("inf"),
                                                    float("-inf")).to(out.dtype))
        return fn

    def verify_logits(ctx, paged, nudge=None):
        kv = {n_: a.clone() for n_, a in snapshot.items()}
        prev = PA.set_paged_impl(paged)
        plain = PA.paged_attention_plain
        if nudge is not None:
            PA.paged_attention_plain = nudged(plain, nudge)
        try:
            with torch.no_grad():
                out, _ = T.decode_verify_paged(qcfg, vparams, block, kv,
                                               vtab, vlen, n_valid, ctx)
        finally:
            PA.set_paged_impl(prev)
            PA.paged_attention_plain = plain
        return out[..., :qcfg.vocab_size]

    #  (d) fp weights: gated at VERIFY_RTOL of the logit scale;
    #  (e) the fused MUXQ ctx: the kernel's attention differs from the
    #      plain version's by f32 ulps (summation order), which can flip
    #      int8 activation codes that 24 random layers amplify.  Its
    #      spread is measured: the plain path against itself with every
    #      attention output nudged by one ulp (3 seeds).  Gated at
    #      NUDGE_FACTOR x the largest such spread.
    vk = verify_logits(FpCtx(), "auto")
    vp = verify_logits(FpCtx(), "ref")
    verr = float((vk - vp).abs().max())
    vscale = float(vp.abs().max())
    qk_ = verify_logits(vctx, "auto")
    qp_ = verify_logits(vctx, "ref")
    qerr = float((qk_ - qp_).abs().max())
    vagree = float((qk_.argmax(-1) == qp_.argmax(-1)).float().mean())
    spreads, nagree = [], []
    for seed in (1, 2, 3):
        qn = verify_logits(vctx, "ref", nudge=seed)
        spreads.append(float((qn - qp_).abs().max()))
        nagree.append(float((qn.argmax(-1) == qp_.argmax(-1)).float().mean()))
    print(f"logits qwen2 verify (int4 pages, k = 4), paged kernel vs plain: "
          f"(d) fp weights max abs err {verr:.3e} (|logits| max {vscale:.3f}, "
          f"tolerance {VERIFY_RTOL} x max); (e) fused MUXQ max abs err "
          f"{qerr:.3e}, argmax agreement {vagree:.3f}; plain vs plain with "
          f"1-ulp nudges: max abs err {[round(x, 4) for x in spreads]}, "
          f"argmax agreement {nagree} (gate: (e) <= {NUDGE_FACTOR} x max)",
          flush=True)
    if not (torch.isfinite(vk).all() and torch.isfinite(qk_).all()) \
            or verr > VERIFY_RTOL * vscale:
        raise AssertionError("qwen2 verify logits: the paged kernel disagrees "
                             "with the plain version in place")
    if qerr > NUDGE_FACTOR * max(spreads):
        raise AssertionError(f"qwen2 verify logits under fused MUXQ: kernel vs "
                             f"plain {qerr} exceeds {NUDGE_FACTOR} x the 1-ulp "
                             f"spread {max(spreads)}")
    del vparams, vart, vctx, vpool, snapshot
    torch.cuda.empty_cache()
    phases.done("qwen2 calibrate + pack + verify logits")

    # the served model: at full vocabulary a random net's greedy stream never
    # revisits a token, so n-gram drafts would never match; with the residual
    # branches scaled down the stream repeats the last token and speculation
    # has drafts to verify
    qparams, qart, kv_calib, n_kv_out = qwen2_artifact(SERVE_BRANCH_SCALE,
                                                       "served")
    # the served stream repeats its last token, so an n-gram draft that
    # continues the prompt's pattern ("aab aab ... a" drafts "b a") is
    # rejected: the verify step's rejection path runs.  The second prompt
    # is the first again: it maps the first's pages, partial page included,
    # and its first k-token write copies that page (copy-on-write over the
    # write's span)
    qprompts = ["aab aab aab a", "aab aab aab a",
                "abc abc abc abc abc abc abc abc",
                "spec spec spec spec spec spec spec"]
    qengine = ServeEngine(qcfg, qart, max_batch=4, s_max=256, prefill_chunk=32,
                          kv_mode="int4", spec_mode="ngram", spec_k=4,
                          device=dev)
    if float(qengine.pool.kv["k_redist"].max()) <= 1.0:
        raise AssertionError("int4 pool runs with identity redistribution")
    qreqs, qrep, qlaunch, qsecs = serve(qengine, qprompts, 16,
                                        "qwen2-0.5b int4 + ngram spec")
    for key in ("rowwise_quantize", "muxq_gemm", "paged_attention[int4]"):
        if qlaunch[key] <= 0:
            raise AssertionError(f"qwen2 serve never launched {key}: {qlaunch}")
    if qrep["spec_verify_steps"] <= 0:
        raise AssertionError("the speculative verify step never ran")
    if not qrep["spec_accepted"] < qrep["spec_proposed"]:
        raise AssertionError("no draft token was rejected: the verify step's "
                             "rejection path never ran")
    if qrep["prefix_hits"] <= 0 or qrep["cow_copies"] <= 0:
        raise AssertionError("the repeated prompt shared no page or copied "
                             f"none: {qrep['prefix_hits']} prefix hits, "
                             f"{qrep['cow_copies']} copies")
    if qreqs[0].out_tokens != qreqs[1].out_tokens:
        raise AssertionError("two identical prompts, one on copied pages, "
                             "gave different streams")
    int8_bpt = PagePool(qcfg, 4, 256, page_size=16, mode="int8",
                        device=dev).stats()["bytes_per_token"]
    ratio = qrep["bytes_per_token"] / int8_bpt
    if ratio != 0.5:
        raise AssertionError(f"int4/int8 bytes_per_token ratio {ratio} != 0.5")
    main_runs["qwen2-0.5b int4 spec"] = qlaunch
    # decode, verify (4 slots x k + 1 rows) and prefill (4 slots x a chunk
    # bucket of 16 or 32) GEMMs of this serve
    time_sites(qengine.ctx, "qwen2", (4, 20, 64, 128), qcfg.d_ff)

    # the same requests on f32 pages without speculation (also the main-path
    # run of the fp page mode): share of tokens where the streams agree
    fengine = ServeEngine(qcfg, qart, max_batch=4, s_max=256, prefill_chunk=32,
                          kv_mode="fp", cache_dtype=torch.float32, device=dev)
    freqs, frep, flaunch, fsecs = serve(fengine, qprompts, 16,
                                        "qwen2-0.5b f32 pages, spec off")
    if flaunch["paged_attention[fp]"] <= 0:
        raise AssertionError(f"fp serve never launched the paged kernel: {flaunch}")
    main_runs["qwen2-0.5b fp"] = flaunch
    same = sum(a == b_ for r1, r2 in zip(qreqs, freqs)
               for a, b_ in zip(r1.out_tokens, r2.out_tokens))
    total = sum(len(r.out_tokens) for r in qreqs)
    # with the residual branches scaled down the tokens come from the
    # embeddings almost alone: this share says little of the pages
    print(f"qwen2 int4+spec vs f32 pages spec off: {same}/{total} tokens agree "
          f"position by position ({same / total:.3f}; uninformative at this "
          f"branch scale); steps {qrep['decode_steps']} vs "
          f"{frep['decode_steps']}, spec accepted {qrep['spec_accepted']} of "
          f"{qrep['spec_proposed']} proposed; {qrep['prefix_hits']} prefix "
          f"hits, {qrep['cow_copies']} copy-on-write copies", flush=True)
    report["serve_qwen2"] = {
        "seconds": qsecs, "launches": qlaunch, "kv_outlier_channels": n_kv_out,
        "report": {k_: v_ for k_, v_ in qrep.items() if k_ != "decode_buckets"},
        "bytes_per_token_ratio_int4_int8": ratio,
        "verify_fp_weights_max_abs_err": verr, "verify_logits_scale": vscale,
        "verify_fused_max_abs_err": qerr,
        "verify_fused_argmax_agreement": vagree,
        "verify_fused_nudge_spreads": spreads,
        "verify_fused_nudge_argmax_agreement": nagree,
        "fp_run": {"seconds": fsecs, "launches": flaunch,
                   "decode_steps": frep["decode_steps"]},
        "token_agreement_vs_fp_spec_off": same / total,
        "streams": [[r.prompt, r.out_tokens] for r in qreqs]}
    phases.done("serve qwen2-0.5b")

    # -- 6. result lines ---------------------------------------------------------
    pa_src = ("src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:161")
    sources = {"rowwise_quantize": ("src/repro_torch/csrc/rowwise_quantize.cu",
                                    "src/repro/kernels/quantize.py:19"),
               "muxq_gemm": ("src/repro_torch/csrc/muxq_gemm.cu",
                             "src/repro/kernels/muxq_gemm.py:27"),
               "paged_attention[fp]": pa_src,
               "paged_attention[int8]": pa_src,
               "paged_attention[int4]": pa_src,
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:26")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timed[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(c[name] for c in main_runs.values()),
                        "max_abs_err": kern[name]["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    report["kernels"] = kernels
    report["main_runs"] = main_runs
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
