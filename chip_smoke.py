#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``) and build the
   hand-written CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel).
2. Hold every kernel against its plain PyTorch version on the card at the
   serving path's shapes, and time the kernel, the plain version and a
   library yardstick beside the kernel's lower bound on this card.
3. Serve gpt2-small at full width (12 layers, d_model 768, random weights
   from a seed) through ``ServeEngine``: calibrate outlier masks with a
   ``CollectCtx`` pass through the fp paged prefill, pack the fused MUXQ
   kernel buffers, serve 4 requests x 16 new tokens on int8 pages, and
   check that the launch counters of all three kernels moved and that the
   kernel path's logits agree with the plain path's.
4. Print one JSON line with every kernel's numbers, the ``nvidia-smi``
   line, and the final ``{"ok": true, "device": ...}`` line.

It imports nothing of JAX or of the reference package.  Details of every
measurement also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, int8 tensor-core ops/s,
# float32 (non-tensor-core) flop/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
F32_FLOPS_S = 67e12

BF16_ATOL = 2e-2    # bf16 pages: the plain version rounds K/V, probs to bf16
F32_ATOL = 1e-4     # f32: only the summation order differs


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, each after reading
    a 64 MB buffer that evicts L2 (the serving path finds weights cold: 12
    layers of them exceed the 50 MB L2); ``flush=None`` times it warm.
    ``fn`` is captured once in a CUDA graph and replayed, so the events
    time the device work and not the Python and launch overhead between
    ops (``call_ms`` measures that)."""
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
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.sum()     # a read leaves L2 full of clean, unrelated lines
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


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


def maybe_time(torch, fn, flush):
    """``time_ms`` of a library yardstick, or None where the library call
    refuses these inputs (``torch._int_mm`` wants M > 16, for one)."""
    try:
        fn()
    except RuntimeError as e:
        print(f"yardstick refused: {str(e).splitlines()[0]}")
        return None
    return time_ms(torch, fn, flush)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.context import CollectCtx
    from repro_torch.core.muxq import QuantConfig
    from repro_torch.core.policy import SitePolicy
    from repro_torch.kernels import build, dispatch, ops
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quantize as RQ
    from repro_torch.models import transformer as T
    from repro_torch.quantize import build_artifact
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

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(logs)} kernels in {report['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev)   # 64 MB
    cfg = get_config("gpt2-small")
    d, f = cfg.d_model, cfg.d_ff
    sites = {"attn_qkv": (d, 3 * d), "attn_out": (d, d), "mlp_up": (d, f),
             "mlp_down": (f, d)}
    gen = torch.Generator().manual_seed(0)
    kern = {}

    def record(name, **kw):
        entry = {"kernel": name, **kw}
        report["checks"].append(entry)
        kern.setdefault(name, {"max_abs_err": 0.0})
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"],
                                        float(kw.get("max_abs_err", 0.0)))

    # -- 2. kernels against their plain versions -------------------------------
    # an outlier run of 8 channels at e = 3: one 512-wide x8 K-block
    packed = {}
    for site, (k, n) in sites.items():
        w = torch.randn(k, n, generator=gen)
        mask = np.zeros(k, bool)
        mask[torch.randperm(k, generator=gen)[:8].numpy()] = True
        mw = ops.prepare_weights(w, mask, 3, bk=512)
        assert int(mw.block_scale[0]) == 8 and mw.n_out == 8
        packed[site] = (mask, dispatch.as_muxq_weights(
            {fld: getattr(mw, fld).to(dev).contiguous()
             for fld in dispatch.BUFFER_FIELDS}))
    for site, (k, n) in sites.items():
        mask, mw = packed[site]
        k_pad = mw.w_int.shape[0]
        for m in (1, 4, 64, 128):
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
    print("kernel check: rowwise_quantize and muxq_gemm bit-exact at "
          f"{len(sites)} sites x M in (1, 4, 64, 128)", flush=True)

    h, dh, ps = cfg.n_heads, cfg.head_dim, 16
    b, n_tab = 4, 8
    n_pages = b * n_tab + 1

    def paged_case(sq, mode, seed):
        g2 = torch.Generator().manual_seed(seed)
        qdt = torch.bfloat16 if mode == "fp" else torch.float32
        q = torch.randn(b, sq, h, dh, generator=g2).to(dev, qdt)
        k = torch.randn(n_pages, ps, h, dh, generator=g2)
        v = torch.randn(n_pages, ps, h, dh, generator=g2)
        # ragged tables: full, short (tail -> scratch page 0), one page, idle
        table = torch.zeros(b, n_tab, dtype=torch.int32)
        table[0] = torch.arange(1, 1 + n_tab)
        table[1, :3] = torch.arange(9, 12)
        table[2, :1] = 17
        pos = torch.tensor([n_tab * ps - sq, 3 * ps - sq, 0, 0], dtype=torch.int32)
        kw = {}
        if mode == "int8":
            parts = quantize_kv(k.to(dev), v.to(dev))
            k, v = parts["k"], parts["v"]
            kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
        else:
            k, v = k.to(dev, torch.bfloat16), v.to(dev, torch.bfloat16)
        return (q, k, v, table.to(dev), pos.to(dev)), kw

    for mode in ("fp", "int8"):
        for sq in (1, 32):
            args, kw = paged_case(sq, mode, 10 * sq + len(mode))
            ok = PA.paged_attention_decode(*args, **kw)
            op = PA.paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((ok.float() - op.float()).abs().max())
            atol = BF16_ATOL if mode == "fp" else F32_ATOL
            if not (torch.isfinite(ok).all() and err <= atol):
                raise AssertionError(f"paged_attention {mode} sq={sq}: max abs "
                                     f"err {err} > {atol}")
            record("paged_attention", mode=mode, sq=sq, max_abs_err=err,
                   atol=atol)
    print("kernel check: paged_attention fp(bf16) and int8 pages, sq in "
          "(1, 32), within tolerance", flush=True)

    # -- timings at the decode shapes (M = 4 slots, the step that dominates
    # the serving run) ----------------------------------------------------
    mask, mw = packed["mlp_up"]
    k, n = sites["mlp_up"]
    k_pad = mw.w_int.shape[0]
    m = 4
    x = torch.randn(m, k, generator=gen).to(dev)
    xq, sx = RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                 in_scale=mw.in_scale)
    def rq_fn():
        return RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                   in_scale=mw.in_scale)

    rq = {"fn": rq_fn, "plain_ms": time_ms(torch, lambda: RQ.rowwise_quantize_plain(
              x, 8, mw.gather_idx, mw.in_scale), flush),
          "library_ms": None,
          "shape": f"x [{m}, {k}] f32 -> int8 [{m}, {k_pad}] (mlp_up)"}
    rq["bound_ms"], rq["bound_by"] = bound(
        m * k * 4 + k_pad * 8 + m * k_pad + m * 4, 4 * m * k_pad, F32_FLOPS_S)

    lib_ms = maybe_time(torch, lambda: torch._int_mm(xq, mw.w_int), flush)
    gm = {"fn": lambda: G.muxq_gemm(xq, mw.w_int, mw.block_scale, sx, mw.sw,
                                    bk=mw.bk),
          "plain_ms": time_ms(torch, lambda: G.muxq_gemm_plain(
              xq, mw.w_int, mw.block_scale, sx, mw.sw, mw.bk), flush),
          "library_ms": lib_ms,
          "shape": f"int8 [{m}, {k_pad}] x [{k_pad}, {n}] (mlp_up)"}
    gm["bound_ms"], gm["bound_by"] = bound(
        m * k_pad + k_pad * n + 4 * (k_pad // mw.bk + m + n) + 4 * m * n,
        2 * m * n * k_pad, INT8_OPS_S)

    # a prefill-width GEMM beside the int8 library GEMM (which needs M > 16)
    xp = torch.randint(-127, 128, (128, k_pad), generator=gen,
                       dtype=torch.int8).to(dev)
    sxp = torch.rand(128, 1, generator=gen).to(dev)
    report["timings"].append({
        "kernel": "muxq_gemm", "m": 128, "k_pad": k_pad, "n": n,
        "ms": time_ms(torch, lambda: G.muxq_gemm(
            xp, mw.w_int, mw.block_scale, sxp, mw.sw, bk=mw.bk), flush),
        "int_mm_ms": maybe_time(torch, lambda: torch._int_mm(xp, mw.w_int), flush),
        "bound_ms": bound(128 * k_pad + k_pad * n + 4 * 128 * n,
                          2 * 128 * n * k_pad, INT8_OPS_S)[0]})

    (q, kp, vp, table, pos), kw = paged_case(1, "int8", 7)
    # decode step of the serving run: 4 live slots, 128-position tables
    pos = torch.tensor([127, 100, 64, 40], dtype=torch.int32, device=dev)
    table = torch.arange(1, 1 + b * n_tab, dtype=torch.int32,
                         device=dev).reshape(b, n_tab)
    pa_args = (q, kp, vp, table, pos)
    n_read = [min(n_tab, int(p) // ps + 1) for p in pos.tolist()]
    keys = sum(n_read) * ps
    page_bytes = ps * h * (2 * dh + 2 * 4)          # K + V codes + f32 scales
    pa_bytes = sum(n_read) * page_bytes + 2 * q.numel() * 4 + table.numel() * 4 + 16
    kd = (kp.float() * kw["k_scale"])[table.long()].reshape(b, -1, h, dh)
    vd = (vp.float() * kw["v_scale"])[table.long()].reshape(b, -1, h, dh)
    kpos = torch.arange(kd.shape[1], device=dev)
    allow = (kpos[None, :] <= pos[:, None])[:, None, None, :]
    qs, ks, vs = q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pa = {"fn": lambda: PA.paged_attention_decode(*pa_args, **kw),
          "plain_ms": time_ms(torch, lambda: PA.paged_attention_plain(
              *pa_args, **kw), flush),
          "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs, attn_mask=allow),
                                flush),
          "shape": f"decode b={b} sq=1 h={h} dh={dh} int8 pages, "
                   f"{keys} keys read"}
    pa["bound_ms"], pa["bound_by"] = bound(pa_bytes, 4 * h * keys * dh,
                                           F32_FLOPS_S)
    timed = {"rowwise_quantize": rq, "muxq_gemm": gm, "paged_attention": pa}
    for name, t in timed.items():
        fn = t.pop("fn")
        t["ms"] = time_ms(torch, fn, flush)
        t["warm_ms"] = time_ms(torch, fn, None)
        t["call_ms"] = call_ms(torch, fn)
        report["timings"].append({"kernel": name, **t})
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"time {name} [{t['shape']}]: kernel {t['ms']:.4f} ms (warm "
              f"L2 {t['warm_ms']:.4f} ms, eager call {t['call_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})  [{card}]", flush=True)
    t128 = report["timings"][0]
    print(f"time muxq_gemm [M=128]: kernel {t128['ms']:.4f} ms, torch._int_mm "
          f"{t128['int_mm_ms']} ms, bound {t128['bound_ms']:.4f} ms  [{card}]",
          flush=True)

    # -- 3. end to end: gpt2-small at full width --------------------------------
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
    policy = SitePolicy.uniform(QuantConfig(
        method="muxq", outlier_mode="static", act_granularity="per_token",
        backend="fused", weight_granularity="per_channel"))
    art = build_artifact(cfg, params, policy, masks)
    runs = {s: int((b_["block_scale"] > 1).sum())
            for s, b_ in art.kernel_buffers.items()}
    n_runs = sum(1 for r in runs.values() if r)
    print(f"calibration: {len(masks)} sites, {sum(int(m_.sum()) for m_ in masks.values())}"
          f" outlier channels; {n_runs} of {len(runs)} packed sites carry a "
          "2^e block run", flush=True)
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
    reqs = [Request(p, max_new_tokens=16) for p in prompts]
    RQ.LAUNCHES = G.LAUNCHES = PA.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"rowwise_quantize": RQ.LAUNCHES, "muxq_gemm": G.LAUNCHES,
                "paged_attention": PA.LAUNCHES}
    rep = engine.metrics.report()
    for r in reqs:
        if not r.done or not (len(r.out_tokens) == 16
                              or r.out_tokens[-1] == 257):
            raise AssertionError(f"request {r.prompt[:20]!r} produced "
                                 f"{len(r.out_tokens)} tokens")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    report["serve"] = {"seconds": serve_s, "launches": launches,
                       "tokens_out": rep["tokens_out"],
                       "decode_steps": rep["decode_steps"],
                       "prefill_steps": rep["prefill_steps"],
                       "prefill_chunks": rep["prefill_chunks"],
                       "outlier_runs": runs}
    print(f"serve: {rep['tokens_out']} tokens, {rep['decode_steps']} decode "
          f"steps, {rep['prefill_steps']} prefill steps in {serve_s:.3f} s "
          f"(host clock, eager, first run); launches {launches}  [{card}]",
          flush=True)

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
    print(f"profile: {steps_a} steps in {wall_a:.3f} s wall ({steps_b} steps "
          f"in {wall_b:.3f} s under the profiler); device busy {dev_s:.4f} s, "
          f"{busy:.1%} of the unprofiled wall ({dev_s / wall_b:.1%} of the "
          "profiled); top kernels: "
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
    print(f"logits: (a) fused kernels bit-equal in situ; (b) paged kernel vs "
          f"plain on fp32 pages max abs err {err_b:.3e} (|logits| max "
          f"{scale_b:.3f}); (c) all-kernel vs all-plain int8 max abs err "
          f"{err_c:.3e}, argmax agreement {agree:.3f}", flush=True)
    if err_b > 1e-3 * scale_b:
        raise AssertionError("(b) paged kernel logits disagree with the plain path")

    # -- 4. result lines -------------------------------------------------------
    sources = {"rowwise_quantize": ("src/repro_torch/csrc/rowwise_quantize.cu",
                                    "src/repro/kernels/quantize.py:19"),
               "muxq_gemm": ("src/repro_torch/csrc/muxq_gemm.cu",
                             "src/repro/kernels/muxq_gemm.py:27"),
               "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:161")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timed[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": kern[name]["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    report["kernels"] = kernels
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
