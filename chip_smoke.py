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
4. The reference's other dense decoders at full width: at every matmul
   site (K, N) of gemma2-9b, qwen2.5-14b, qwen1.5-110b and internvl2-2b
   (K up to 49152, N up to 98304) and M 4 and 128, ``rowwise_quantize``
   and ``muxq_gemm`` bit for bit against their plain versions (the GEMM
   also against the paper's two-GEMM oracle at one site), on k-major
   buffers built on the card, and timed beside ``torch._int_mm``;
   ``paged_attention`` at dh 224 / g 2 (gemma2, window 4096 and softcap
   50, rows at positions 4100-4700), dh 128 / g 5 and g 8 on bf16, int8
   and int4 pages at sq 1/4/32, and timed at five serving shapes.
5. Serve gpt2-small at full width (12 layers, random weights from a seed,
   int8 pages): calibrate, pack the fused MUXQ kernel buffers, serve 4
   requests x 16 tokens, time ``muxq_gemm`` at each distinct site shape
   of the served artifact (its own weights; decode and prefill M, beside
   ``torch._int_mm``) and ``rowwise_quantize`` at the widest K, profile a
   repeat run, and hold the kernel path's logits against the plain
   path's.
6. The same serve on a fresh engine with the flight recorder and the
   quality observer on (the observer installed on the activation seam):
   the stream equal to phase 5's, no lifecycle or Chrome-trace error,
   the trace written under ``build/``, only KV-pool samples observed.
7. The paper's grid on the ``fake`` backend, gpt2-small at full width on
   the same weights: calibrate on two ``TokenPipeline`` batches, then for
   fp, naive, MUXQ (paper and fused forms), LLM.int8(), SmoothQuant and
   MUXQ + SmoothQuant at per-tensor activations and weights, and naive
   and MUXQ at per-token / per-channel, print the mean cross-entropy on 4
   batches of 4 x 256 tokens and the logits' relative distance from fp.
   At one full-width site, hold the fake fused MUXQ form against the
   real-int8 ``muxq_matmul_fused`` (f32 dot-product error bound), and
   ``muxq_matmul_fused`` against ``dispatch.fused_matmul`` through the
   kernels (equal codes and scales, FUSED_RTOL).
8. Write a bundle and serve it: ``quantize_model`` with MUXQ + SmoothQuant
   on the fused backend (pack target ``fused``, int4 KV calibration),
   ``save`` (under ``build/``, removed once loaded), ``QuantArtifact.load``,
   and serve 4 requests x 16 tokens on int4 pages from the loaded bundle
   and from the in-memory artifact: identical streams and counters, and
   the fused kernels bit-equal to their plain versions in place.
9. Run the serving launcher in-process (``--backend fused --quant muxq
   --kv-mode int4 --spec-mode ngram --json-out ...``) on the reduced gpt2.
10. Serve qwen2-0.5b at full width (24 layers, d 896, 14/2 heads, d_ff
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
11. Serve qwen2.5-14b at full width (d 5120, 40/8 heads, dh 128, d_ff
   13824, vocab 152064, untied head), depth cut to 4 of 48 layers: seeded
   weights with planted outliers, calibrated through the dense forward,
   fused MUXQ, 4 requests x 16 tokens on int8 pages.  In place: (a) the
   fused kernels bit-equal to their plain versions (prefill chunk and
   decode step logits); at fp weights the paged kernel against its plain
   version, (b) on f32 pages within LOGIT_RTOL of the logit scale, (b')
   on the served pages within NUDGE_FACTOR x the spread that 1-ulp
   nudges of the plain version's attention make; (c) the logits through
   ``lm_head`` differ from those through the embedding.
12. Serve gemma2-9b at full width (d 3584, 16/8 heads, dh 224, d_ff 14336,
   vocab 256000, window 4096, softcaps 50/30, sandwich norms, scaled
   embedding), 2 of 42 layers (one local/global period): the same flow on
   int4 pages with n-gram speculation (k = 4), gates (a), (b) and (b') on
   a verify block.
13. The MoE family's expert sites at full width: ``dispatch.fused_emm``
   (one ``rowwise_quantize`` over the E*C rows, one ``muxq_gemm`` per
   expert) at llama4-scout's and dbrx's ``moe_up`` / ``moe_down`` (E 16;
   K up to 10752, N up to 21504) and C 8 (decode) and 128 (a prefill
   step of 4 slots x 32 tokens), bit for bit against the plain per-expert
   path, on per-expert k-major buffers built on the card; 16 x the GEMM
   (and its plain version) and the whole ``fused_emm`` timed beside 16 x
   ``torch._int_mm``.
14. Serve llama4-scout-17b-a16e at full width (d 5120, 40/8 heads, d_ff
   8192, vocab 202048, untied head, 16 experts top-1 and the shared
   expert), 2 of 48 layers: phase 11's flow and gates (a), (b), (b') on
   int8 pages, the expert choices of gate (a) equal on the kernel and
   plain paths, the launches of one decode step counted (one quantize a
   site, one GEMM a dense site and an expert), the tokens each expert was
   routed, the peak device memory.
15. Serve dbrx-132b at full width (d 6144, 48/8 heads, d_ff 10752, vocab
   100352, 16 experts top-4), 1 of 40 layers: the same on int4 pages with
   n-gram speculation (k = 4), the gates on a verify block; served with
   the residual branches scaled down and the head read as the
   embedding's transpose, so that the greedy stream repeats and drafts
   match.
16. Print one JSON line with every kernel's numbers, the ``nvidia-smi``
   line, and the final ``{"ok": true, "device": ...}`` line.

``launches`` in the JSON line counts the launches of the full-width
serving runs of phases 5, 8, 10, 11, 12, 14 and 15 (each run starts from
zero counts); the traced serve of phase 6 and the launcher's reduced-width run
of phase 9 keep their own counts in ``chip_smoke.json``.  ``flash_attention`` is on no
serving path and has 0.  It imports nothing of JAX or of the
reference package.  Details of every measurement also go to
``chip_smoke.json`` in the output directory at the root of the checkout
(``out_dir`` below, listed in ``.gitignore``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
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
                            # output projections scaled down (phase 10);
                            # gemma2's sandwich post-norm gains (phase 12);
                            # dbrx's attn_out / moe_down scales (phase 15)
VERIFY_RTOL = 1e-3  # in-situ verify logits on int4 pages with fp weights,
                    # paged kernel vs plain, relative to max |logits|: the
                    # attention sums' order differs, and an ulp may move an
                    # int4 K/V code
FUSED_RTOL = 4 * 2.0 ** -24    # muxq_matmul_fused vs the fused kernels at
                               # one site: the same int32 sum times the same
                               # two f32 scales, up to the order of the two
                               # products (2 roundings)
NUDGE_FACTOR = 2.0  # in-situ verify logits under fused MUXQ, kernel vs plain:
                    # at most this x the plain-vs-plain spread that 1-ulp
                    # nudges of every attention output make
LOGIT_RTOL = 1e-3   # in-situ logits of the wide serves, paged kernel vs
                    # plain at fp weights on f32 pages, relative to max
                    # |logits| (only the attention sums' order differs)

# the reference's other dense decoders (phase 4: every site and attention
# shape at full width; phases 11-12 serve two of them at full width, depth
# cut to fit one card and the time limit)
WIDE_ARCHS = ("gemma2-9b", "qwen2.5-14b", "qwen1.5-110b", "internvl2-2b")
WIDE_MS = (4, 128)          # decode and prefill (4 slots x a 32-token chunk)
TWO_MATMUL_SITE = ("qwen2.5-14b", "mlp_down", 128)   # the second GEMM oracle
WINDOW_SPAN = 600           # gemma2's paged rows sit up to this far past its
                            # window (positions 4100-4700 at window 4096)
Q14_LAYERS = 4              # qwen2.5-14b served at 4 of its 48 layers
G9_LAYERS = 2               # gemma2-9b at 2 of 42: one local/global period
# the MoE family (phases 13-15): the expert sites at full width, then
# llama4-scout and dbrx served at full width, depth cut
MOE_ARCHS = ("llama4-scout-17b-a16e", "dbrx-132b")
MOE_L4_LAYERS = 2           # llama4-scout-17b-a16e at 2 of its 48 layers
MOE_DBRX_LAYERS = 1         # dbrx-132b at 1 of its 40 layers


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
    from repro_torch.core import quantizers as Q
    from repro_torch.core.context import CollectCtx, FpCtx, as_ctx
    from repro_torch.core.muxq import (QuantConfig, muxq_fake_quant_act,
                                       muxq_int32, muxq_matmul_fused, qmatmul)
    from repro_torch.core.policy import SitePolicy
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import build, dispatch, ops
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quantize as RQ
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.common import cross_entropy
    from repro_torch.obs.quality import QualityObserver
    from repro_torch.obs.trace import (TraceRecorder, chrome_errors,
                                       lifecycle_errors)
    from repro_torch.quantize import (QuantArtifact, build_artifact,
                                      calibrate_model, quantize_model)
    from repro_torch.serve import kvq
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.kvcache import quantize_kv
    from repro_torch.serve.pool import PagePool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
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
        return PA.paged_attention_plain(q.float(), kd, vd, table, pos,
                                        window=kw.get("window"),
                                        softcap=kw.get("softcap")).to(q.dtype)

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

    # -- 4. the reference's other dense decoders: kernels at their shapes ------
    # every matmul site (K_pad, N) of gemma2-9b, qwen2.5-14b, qwen1.5-110b
    # and internvl2-2b at full width, and their attention shapes (dh 224 at
    # g 2 with gemma2's window and softcap, dh 128 at g 5 and g 8, dh 128 at
    # g 2), each kernel against its plain version and timed
    wide = {a: get_config(a) for a in WIDE_ARCHS}

    def device_site(k, n, seed):
        """A site's served buffers built on the card: the channel map that
        ``ops.prepare_weights`` gives 8 outlier channels at e = 2 (one
        512-wide x4 K-block; the map does not depend on the weight's
        values), a random k-major int8 W^T [n, K_pad] and weight scales."""
        g_ = torch.Generator().manual_seed(seed)
        mask = np.zeros(k, bool)
        mask[torch.randperm(k, generator=g_)[:8].numpy()] = True
        meta = ops.prepare_weights(np.zeros((k, 1), np.float32), mask, 2,
                                   bk=512)
        k_pad = meta.gather_idx.shape[0]
        gd = torch.Generator(device=dev).manual_seed(seed)
        wt = torch.randint(-127, 128, (n, k_pad), generator=gd, device=dev,
                           dtype=torch.int8)
        sw = torch.rand(1, n, generator=gd, device=dev) * 1e-3 + 1e-4
        return mask, ops.MuxqWeights(
            w_int=wt.T, sw=sw, block_scale=meta.block_scale.to(dev),
            gather_idx=meta.gather_idx.to(dev), in_scale=meta.in_scale.to(dev),
            bk=meta.bk, k_orig=k)

    def site_shapes(c):
        qkv = (c.n_heads + 2 * c.n_kv_heads) * c.head_dim
        up = 2 * c.d_ff if c.mlp_type == "swiglu" else c.d_ff
        return {"attn_qkv": (c.d_model, qkv),
                "attn_out": (c.n_heads * c.head_dim, c.d_model),
                "mlp_up": (c.d_model, up), "mlp_down": (c.d_ff, c.d_model)}

    n_sites = 0
    for arch, c in wide.items():
        for base, (k, n) in site_shapes(c).items():
            mask, mw = device_site(k, n, n_sites)
            n_sites += 1
            k_pad = mw.w_int.shape[0]
            for m in WIDE_MS:
                x = torch.randn(m, k, generator=gen).to(dev)
                x[:, torch.from_numpy(mask)] *= 40.0
                qk, sk = RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                             in_scale=mw.in_scale)
                qp, sp = RQ.rowwise_quantize_plain(x, 8, mw.gather_idx,
                                                   mw.in_scale)
                yk = G.muxq_gemm(qk, mw.w_int, mw.block_scale, sk, mw.sw,
                                 bk=mw.bk)
                yp = G.muxq_gemm_plain(qk, mw.w_int, mw.block_scale, sk,
                                       mw.sw, mw.bk)
                torch.cuda.synchronize()
                if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                    raise AssertionError(f"rowwise_quantize {arch} {base} "
                                         f"m={m}: codes or scales differ")
                if not torch.equal(yk, yp):
                    raise AssertionError(
                        f"muxq_gemm {arch} {base} m={m} K_pad={k_pad} N={n}: "
                        f"not bit-equal (max abs err "
                        f"{float((yk - yp).abs().max())})")
                record("rowwise_quantize", site=f"{arch} {base}", m=m, k=k,
                       k_pad=k_pad, max_abs_err=0.0)
                record("muxq_gemm", site=f"{arch} {base}", m=m, k_pad=k_pad,
                       n=n, max_abs_err=0.0)
                if (arch, base, m) == TWO_MATMUL_SITE:
                    # the second oracle: the paper's literal two-GEMM form
                    y2 = kref.muxq_gemm_two_matmul_ref(
                        qk, mw.w_int, mw.block_scale, sk, mw.sw, mw.bk)
                    torch.cuda.synchronize()
                    if not torch.equal(yk, y2):
                        raise AssertionError(f"muxq_gemm {arch} {base} m={m}: "
                                             "not bit-equal to the two-GEMM "
                                             "oracle")
                    record("muxq_gemm", vs="two-GEMM oracle",
                           site=f"{arch} {base}", m=m, k_pad=k_pad, n=n,
                           max_abs_err=0.0)
                xp_ = padded_rows(qk)       # padded once, outside the timed call

                def gemm_fn(qk=qk, sk=sk, mw=mw):
                    return G.muxq_gemm(qk, mw.w_int, mw.block_scale, sk,
                                       mw.sw, bk=mw.bk)

                def rq_fn(x=x, mw=mw):
                    return RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                               in_scale=mw.in_scale)
                row = {"kernel": "muxq_gemm", "model": arch, "site": base,
                       "m": m, "k_pad": k_pad, "n": n}
                row["ms"], row["spread_ms"] = time_ms(torch, gemm_fn, flush)
                row["warm_ms"], _ = time_ms(torch, gemm_fn, None)
                row["plain_ms"] = time_ms(torch, lambda: G.muxq_gemm_plain(
                    qk, mw.w_int, mw.block_scale, sk, mw.sw, mw.bk), flush)[0]
                row["int_mm_ms"] = maybe_time(
                    torch, lambda: torch._int_mm(xp_, mw.w_int), flush)
                row["bound_ms"], row["bound_by"] = bound(
                    m * k_pad + k_pad * n + 4 * (k_pad // mw.bk + m + n)
                    + 4 * m * n, 2 * m * n * k_pad, INT8_OPS_S)
                qrow = {"kernel": "rowwise_quantize", "model": arch,
                        "site": base, "m": m, "k_in": k, "k_pad": k_pad}
                qrow["ms"], qrow["spread_ms"] = time_ms(torch, rq_fn, flush)
                qrow["plain_ms"] = time_ms(torch, lambda: RQ.rowwise_quantize_plain(
                    x, 8, mw.gather_idx, mw.in_scale), flush)[0]
                qrow["bound_ms"], qrow["bound_by"] = bound(
                    m * k * 4 + k_pad * 8 + m * k_pad + m * 4, 4 * m * k_pad,
                    F32_FLOPS_S)
                report["timings"] += [row, qrow]
                print(f"wide {arch} {base} M={m} K={k} K_pad={k_pad} N={n}: "
                      f"codes and outputs bit-equal; muxq_gemm {row['ms']:.4f} "
                      f"ms (spread {row['spread_ms'][0]:.4f}-"
                      f"{row['spread_ms'][1]:.4f}; warm {row['warm_ms']:.4f}; "
                      f"plain {row['plain_ms']:.4f}), torch._int_mm "
                      f"{row['int_mm_ms']} ms (M padded to "
                      f"{max(m, INT_MM_ROWS)}), bound {row['bound_ms']:.5f} "
                      f"({row['bound_by']}); rowwise_quantize "
                      f"{qrow['ms']:.4f} ms (plain {qrow['plain_ms']:.4f}), "
                      f"bound {qrow['bound_ms']:.6f} ({qrow['bound_by']})  "
                      f"[{card}]", flush=True)
            del mw
    torch.cuda.empty_cache()
    print(f"kernel check: rowwise_quantize and muxq_gemm bit-exact at "
          f"{n_sites} sites of {len(wide)} configs x M in {WIDE_MS}; the "
          f"two-GEMM oracle at {TWO_MATMUL_SITE}", flush=True)

    def wide_paged_case(c, mode, sq, pos_list, seed, qdt=torch.float32):
        """Pages for one slot per entry of ``pos_list`` (full tables up to
        the slot's last row), at config ``c``'s attention shape; gemma2's
        local layers pass its window and softcap."""
        dh_, kvh_, heads_ = c.head_dim, c.n_kv_heads, c.n_heads
        g2 = torch.Generator().manual_seed(seed)
        b_ = len(pos_list)
        n_tab_ = (max(pos_list) + sq - 1) // ps + 1
        n_pages_ = b_ * n_tab_ + 1
        q = torch.randn(b_, sq, heads_, dh_, generator=g2).to(dev, qdt)
        k = torch.randn(n_pages_, ps, kvh_, dh_, generator=g2).to(dev)
        v = torch.randn(n_pages_, ps, kvh_, dh_, generator=g2).to(dev)
        table = torch.arange(1, n_pages_, dtype=torch.int32,
                             device=dev).reshape(b_, n_tab_)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        kw = {}
        if c.attn_softcap is not None:
            kw = {"window": c.window_size, "softcap": c.attn_softcap}
        if mode == "int8":
            parts = quantize_kv(k, v)
            k, v = parts["k"], parts["v"]
            kw.update(k_scale=parts["k_scale"], v_scale=parts["v_scale"])
        elif mode == "int4":
            hot_k, hot_v = 5 % dh_, (dh_ // 2 + 5) % dh_
            mask = np.zeros((kvh_, dh_), bool)
            mask[:, [hot_k, hot_v]] = True
            redist = torch.from_numpy(kvq.redist_from_mask(mask)).to(dev)
            k[..., hot_k] *= 8.0
            v[..., hot_v] *= 8.0
            parts = kvq.Int4KVQuantizer(redist, redist).quantize(k, v)
            k, v = parts["k"], parts["v"]
            kw.update(k_scale=parts["k_scale"], v_scale=parts["v_scale"],
                      k_redist=redist, v_redist=redist)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        return (q, k, v, table, pos), kw

    def wide_positions(c, sq):
        """gemma2: rows past its window (4100-4700 at window 4096), so the
        window drops each slot's first pages; the others: a ragged batch
        up to 700 positions."""
        if c.attn_softcap is not None:
            w = c.window_size
            return [w + 4, w + WINDOW_SPAN // 2, w + WINDOW_SPAN - sq,
                    w + WINDOW_SPAN // 4]
        return [700, 431, 64, 0]

    n_paged = 0
    for arch in ("gemma2-9b", "qwen2.5-14b", "qwen1.5-110b"):
        c = wide[arch]
        for mode in ("fp", "int8", "int4"):
            for sq in (1, 4, 32):
                args, kw = wide_paged_case(c, mode, sq, wide_positions(c, sq),
                                           1000 + 10 * sq + n_paged)
                held_paged(f"paged_attention[{mode}]", args, kw, sq=sq,
                           g=c.n_heads // c.n_kv_heads, dh=c.head_dim,
                           model=arch, window=kw.get("window"))
                n_paged += 1
        # bf16 queries, once per shape, against the f32 twin as well
        args, kw = wide_paged_case(c, "int4", 4, wide_positions(c, 4),
                                   2000 + n_paged, qdt=torch.bfloat16)
        held_paged("paged_attention[int4]", args, kw, sq=4,
                   g=c.n_heads // c.n_kv_heads, dh=c.head_dim, model=arch,
                   q="torch.bfloat16", window=kw.get("window"))
        n_paged += 1
    for chk in report["checks"]:
        if chk["kernel"].startswith("paged") and "model" in chk:
            print(f"  {chk['kernel']} {chk['model']} dh {chk['dh']} g "
                  f"{chk['g']} sq {chk['sq']} window {chk['window']} "
                  f"{chk.get('q', 'f32')} vs {chk['vs']}: max abs err "
                  f"{chk['max_abs_err']:.3g}, worst element at "
                  f"{chk['max_ratio']:.3f} of its limit")
    print(f"kernel check: paged_attention at dh 224 g 2 (window "
          f"{wide['gemma2-9b'].window_size} crossed, softcap "
          f"{wide['gemma2-9b'].attn_softcap}), dh 128 g 5 and g 8, on bf16, "
          f"int8 and int4 pages, sq 1/4/32: {n_paged} cases within "
          "tolerance", flush=True)

    def wide_paged_timing(arch, mode, sq, pos_list, label):
        """The paged kernel at a wide shape, beside its plain version and
        SDPA on the gathered, dequantized K/V (none where a softcap makes
        SDPA another function); bound from the pages the rows' windows
        read and the (query, key) pairs they allow."""
        c = wide[arch]
        dh_, kvh_, heads_ = c.head_dim, c.n_kv_heads, c.n_heads
        args, kw = wide_paged_case(c, mode, sq, pos_list, 7 + sq)
        q, kp, vp, table, pos = args
        w = kw.get("window", 1 << 30)
        pairs = sum(min(p + i + 1, w) for p in pos_list for i in range(sq))
        n_read = sum((p + sq - 1) // ps - max(0, p - w + 1) // ps + 1
                     for p in pos_list)
        nbytes = (n_read * ps * kvh_ * page_cost[mode](kp.element_size())
                  + 2 * q.numel() * 4 + table.numel() * 4 + 16
                  + (2 * kvh_ * dh_ * 4 if mode == "int4" else 0))
        row = {"kernel": f"paged_attention[{mode}]", "model": arch,
               "shape": f"{label}: b={len(pos_list)} sq={sq} h={heads_} "
                        f"kvh={kvh_} dh={dh_} {mode} pages, {n_read * ps} "
                        f"key positions read",
               "plain_ms": time_ms(torch, lambda: PA.paged_attention_plain(
                   *args, **kw), flush)[0], "library_ms": None}
        if "softcap" not in kw:
            if mode == "int8":
                kd, vd = kp.float() * kw["k_scale"], vp.float() * kw["v_scale"]
            else:
                qz = kvq.Int4KVQuantizer(kw["k_redist"], kw["v_redist"])
                kd, vd = qz.dequantize({"k": kp, "v": vp,
                                        "k_scale": kw["k_scale"],
                                        "v_scale": kw["v_scale"]},
                                       torch.float32)
            b_ = len(pos_list)
            kd = kd[table.long()].reshape(b_, -1, kvh_, dh_).transpose(1, 2)
            vd = vd[table.long()].reshape(b_, -1, kvh_, dh_).transpose(1, 2)
            kd = kd.repeat_interleave(heads_ // kvh_, dim=1).contiguous()
            vd = vd.repeat_interleave(heads_ // kvh_, dim=1).contiguous()
            kpos = torch.arange(kd.shape[2], device=dev)
            qpos = pos[:, None] + torch.arange(sq, device=dev)[None]
            allow = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
            qs = q.transpose(1, 2)
            row["library_ms"] = time_ms(torch, lambda: sdpa(
                qs, kd, vd, attn_mask=allow), flush)[0]
        fn = lambda: PA.paged_attention_decode(*args, **kw)
        row["ms"], row["spread_ms"] = time_ms(torch, fn, flush)
        row["warm_ms"], _ = time_ms(torch, fn, None)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 4 * dh_ * heads_ * pairs, F32_FLOPS_S)
        report["timings"].append(row)
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"time {row['kernel']} [{row['shape']}]: kernel {row['ms']:.4f} "
              f"ms (spread {row['spread_ms'][0]:.4f}-{row['spread_ms'][1]:.4f}"
              f"; warm {row['warm_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})  [{card}]", flush=True)

    g9w = wide["gemma2-9b"].window_size
    wide_paged_timing("qwen2.5-14b", "int8", 1, [127, 100, 64, 40],
                      "qwen2.5-14b decode")
    wide_paged_timing("qwen2.5-14b", "int8", 32, [96, 64, 32, 0],
                      "qwen2.5-14b prefill chunk")
    wide_paged_timing("qwen1.5-110b", "int8", 1, [127, 100, 64, 40],
                      "qwen1.5-110b decode")
    span = [g9w + WINDOW_SPAN, g9w + WINDOW_SPAN // 2, g9w + WINDOW_SPAN // 4,
            g9w + 4]
    wide_paged_timing("gemma2-9b", "int4", 1, [p_ - g9w for p_ in span],
                      "gemma2-9b decode inside the window")
    wide_paged_timing("gemma2-9b", "int4", 1, span,
                      "gemma2-9b decode past the window")
    wide_paged_timing("gemma2-9b", "int4", 4, [p_ - 3 for p_ in span],
                      "gemma2-9b verify past the window")
    report["wide_shapes"] = {"archs": {a: dataclasses.asdict(c)
                                       for a, c in wide.items()},
                             "sites": n_sites, "paged_cases": n_paged}
    phases.done("kernels at the other dense configs' shapes")

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

    # -- 5. end to end: gpt2-small at full width --------------------------------
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
    greqs, rep, launches, serve_s = serve(engine, prompts, 16,
                                          "gpt2-small int8")
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
    phases.done("serve gpt2-small")

    # -- 6. observability: the same serve with the flight recorder and the
    # quality observers on -----------------------------------------------------
    # a fresh engine on the same artifact, the observer installed on the
    # activation seam as the launcher's --obs installs it: the stream must
    # equal the untraced serve's, the recorded lifecycle and the exported
    # Chrome trace must be well formed, and no activation is observed inside
    # the serve steps (only the KV pool's samples)
    recorder, quality = TraceRecorder(), QualityObserver()
    prev_obs = dispatch.set_quality_observer(quality)
    try:
        tengine = ServeEngine(cfg, art, max_batch=4, s_max=256,
                              prefill_chunk=32, kv_mode="int8",
                              recorder=recorder, quality=quality, device=dev)
        treqs, trep, tlaunch, tsecs = serve(tengine, prompts, 16,
                                            "gpt2-small int8, traced and "
                                            "observed")
    finally:
        dispatch.set_quality_observer(prev_obs)
    if [r.out_tokens for r in treqs] != [r.out_tokens for r in greqs]:
        raise AssertionError("the traced serve's stream differs from the "
                             "untraced serve's")
    life = lifecycle_errors(recorder.events, decode_steps=trep["decode_steps"])
    trace_path = recorder.export_chrome(ROOT / "build" / "chip_smoke_trace.json")
    chrome = chrome_errors(trace_path)
    snap = quality.snapshot()
    if life or chrome:
        raise AssertionError(f"trace errors: lifecycle {life}, chrome {chrome}")
    if set(snap["sites"]) != {"kv/k", "kv/v"} or snap["pool_samples"] <= 0:
        raise AssertionError(f"quality snapshot: sites {sorted(snap['sites'])}"
                             f", {snap['pool_samples']} pool samples (the "
                             "serve steps must observe no activation)")
    n_compile = sum(e["name"] == "COMPILE" for e in recorder.events)
    print(f"observability: stream equal to the untraced serve's; "
          f"{len(recorder.events)} events ({n_compile} COMPILE, "
          f"{recorder.dropped} dropped), lifecycle and chrome errors none; "
          f"trace {trace_path.relative_to(ROOT)} "
          f"{trace_path.stat().st_size} bytes; quality snapshot: "
          f"{len(snap['sites'])} sites, {snap['pool_samples']} pool samples, "
          f"kv/k clip rate {snap['sites']['kv/k']['clip_rate']:.4f}; serve "
          f"{tsecs:.3f} s (untraced {serve_s:.3f} s, single host-clock "
          f"runs)  [{card}]", flush=True)
    report["observability"] = {
        "seconds": tsecs, "untraced_seconds": serve_s,
        "events": len(recorder.events), "compile_events": n_compile,
        "trace_bytes": trace_path.stat().st_size, "quality": snap,
        "launches": tlaunch}
    del engine, tengine, art, cal_pool
    torch.cuda.empty_cache()
    phases.done("observability (gpt2-small traced)")

    # -- 7. the paper's grid on the fake backend, gpt2-small at full width ------
    # the same weights; mean cross-entropy on the synthetic corpus, and the
    # logits' relative distance from the fp logits, for every method of the
    # paper's Table 1 (static calibrated masks, exp_factor 2)
    pipe = TokenPipeline(PipelineConfig(seq_len=256, global_batch=4, seed=0))
    grid_cal = [next(pipe) for _ in range(2)]
    grid_eval = [pipe.batch_at(100 + i) for i in range(4)]
    stats, _ = calibrate_model(cfg, params, grid_cal, device=dev)
    per_tensor = dict(outlier_mode="static", act_granularity="per_tensor",
                      weight_granularity="per_tensor")
    per_token = dict(outlier_mode="static", act_granularity="per_token",
                     weight_granularity="per_channel")
    grid = {"fp": None,
            "naive per-tensor": QuantConfig(method="naive", **per_tensor),
            "muxq paper per-tensor": QuantConfig(method="muxq", **per_tensor),
            "muxq fused per-tensor": QuantConfig(method="muxq", muxq_form="fused",
                                                 **per_tensor),
            "llm_int8 per-tensor": QuantConfig(method="llm_int8", **per_tensor),
            "smoothquant per-tensor": QuantConfig(method="smoothquant",
                                                  **per_tensor),
            "muxq_smooth per-tensor": QuantConfig(method="muxq_smooth",
                                                  **per_tensor),
            "naive per-token": QuantConfig(method="naive", **per_token),
            "muxq per-token": QuantConfig(method="muxq", **per_token)}
    grid_out, fp_logits = {}, []
    with torch.no_grad():
        for label, qc in grid.items():
            ctx = FpCtx() if qc is None else quantize_model(
                cfg, params, stats, qc, prequantize=False, device=dev).ctx(dev)
            ces, dist = [], []
            for i, batch in enumerate(grid_eval):
                tokens = torch.as_tensor(batch["tokens"], device=dev)
                logits = T.forward(cfg, params, tokens, ctx)["logits"][
                    ..., :cfg.vocab_size]
                ces.append(float(cross_entropy(
                    logits, torch.as_tensor(batch["labels"], device=dev),
                    cfg.vocab_size)))
                if qc is None:
                    fp_logits.append(logits)
                dist.append(float((logits - fp_logits[i]).norm()
                                  / fp_logits[i].norm()))
            ce = sum(ces) / len(ces)
            rel = sum(dist) / len(dist)
            if not all(math.isfinite(v) for v in ces + dist):
                raise AssertionError(f"paper grid {label}: non-finite {ces} {dist}")
            grid_out[label] = {"cross_entropy": ce, "logits_rel_dist": rel,
                               "per_batch": ces}
            print(f"paper grid [{label}]: mean cross-entropy {ce:.6f} over "
                  f"{len(grid_eval)} batches of {tuple(tokens.shape)} tokens, "
                  f"logits |q - fp| / |fp| {rel:.6f}  [{card}]", flush=True)
    del fp_logits
    # one full-width site (layer 0 mlp_up, its calibrated mask): (i) the fake
    # fused form against the real-int8 muxq_matmul_fused (per-tensor): the
    # int product is exact, the fake one an f32 dot product, so the bound is
    # the standard f32 dot-product error gamma_(K+4) * (|xq| @ |wq|); (ii)
    # muxq_matmul_fused (per-token, per-channel) against dispatch.fused_matmul
    # through the two kernels: equal codes and scales, outputs within
    # FUSED_RTOL (the same int32 sum times the same two scales)
    site = "layer0/mlp_up"
    w_site = params["layers"][0]["mlp"]["wi"]
    m_site = torch.as_tensor(stats.masks()[site], device=dev)
    if not bool(m_site.any()):
        raise AssertionError(f"{site}: the calibrated mask is empty")
    xs = torch.randn(64, d, generator=torch.Generator().manual_seed(6)).to(dev)
    xs[:, m_site] *= 40.0
    qc = QuantConfig(method="muxq", muxq_form="fused", **per_tensor)
    fake = qmatmul(xs, w_site, qc, mask=m_site)
    real = muxq_matmul_fused(xs, w_site, qc.replace(real_int8=True), m_site)
    xq = muxq_fake_quant_act(xs, qc, m_site)
    wq = Q.fake_quant(w_site, 8, "per_tensor")
    dot_bound = (d + 4) * 2.0 ** -24 * (xq.abs() @ wq.abs())
    err_i = float((fake - real).abs().max())
    if not bool(((fake - real).abs() <= dot_bound).all()):
        raise AssertionError(f"{site}: fake fused MUXQ vs real int8 max abs err "
                             f"{err_i} over the f32 dot-product bound")
    qt = QuantConfig(method="muxq", **per_token)
    bi, sb, _, _, _ = muxq_int32(xs, w_site, qt, m_site)
    y_ref = muxq_matmul_fused(xs, w_site, qt, m_site)
    buf = dispatch.buffer_to(dispatch.pack_site_buffer(
        w_site, m_site.cpu().numpy(), qt.replace(backend="fused")), dev)
    kq, ks = RQ.rowwise_quantize(xs, 8, gather_idx=buf["gather_idx"],
                                 in_scale=buf["in_scale"])
    live = buf["in_scale"] != 0
    y_kern = dispatch.fused_matmul(xs, buf)
    torch.cuda.synchronize()
    if not (torch.equal(kq[:, live], bi[:, buf["gather_idx"][live].long()])
            and not bool(kq[:, ~live].any()) and torch.equal(ks, sb)):
        raise AssertionError(f"{site}: kernel codes differ from muxq_matmul_fused's")
    err_ii = float((y_kern - y_ref).abs().max())
    if not bool(((y_kern - y_ref).abs() <= FUSED_RTOL * y_ref.abs()).all()):
        raise AssertionError(f"{site}: fused kernels vs muxq_matmul_fused max abs "
                             f"err {err_ii} over rtol {FUSED_RTOL}")
    print(f"paper grid site {site} [64 x {d}] @ [{d} x {w_site.shape[1]}], "
          f"{int(m_site.sum())} outlier channels: (i) fake fused form vs real "
          f"int8 max abs err {err_i:.3e} (within the f32 dot-product bound); "
          f"(ii) kernels vs muxq_matmul_fused: codes and scales equal, max abs "
          f"err {err_ii:.3e} (rtol {FUSED_RTOL})", flush=True)
    report["paper_grid"] = {"methods": grid_out, "site": site,
                            "fake_vs_real_max_abs_err": err_i,
                            "kernels_vs_reference_max_abs_err": err_ii}
    phases.done("paper grid (fake backend)")

    # -- 8. write, load and serve a bundle at full width ------------------------
    # MUXQ + SmoothQuant on the fused backend, only the kernel buffers kept
    # (pack target "fused"), int4 KV calibration; saved, loaded back, and
    # served on int4 pages beside the in-memory artifact.  The bundle (its
    # f32 embedding alone is 154 MB) goes under build/, not the output
    # directory, and is removed once loaded; its files' sizes are recorded
    out_dir = ROOT / "chiprun_out"
    spol = SitePolicy.uniform(QuantConfig(method="muxq_smooth", backend="fused",
                                          **per_token))
    sart = quantize_model(cfg, params, grid_cal, spol, pack_target="fused",
                          device=dev)
    bundle = Path(sart.save(ROOT / "build" / "chip_smoke_bundle"))
    lart = QuantArtifact.load(bundle)
    bundle_files = {f.name: f.stat().st_size for f in sorted(bundle.iterdir())}
    shutil.rmtree(bundle)
    print(f"bundle: {len(lart.kernel_buffers)} fused sites, "
          f"{len(lart.smooth_factors)} smooth factors, kv_calib "
          f"{sorted(lart.kv_calib)}, meta {lart.meta}; files {bundle_files}",
          flush=True)
    serve_kw = dict(max_batch=4, s_max=256, prefill_chunk=32, kv_mode="int4",
                    device=dev)
    mem_engine = ServeEngine(cfg, sart, **serve_kw)
    disk_engine = ServeEngine(cfg, lart, **serve_kw)
    mreqs, mrep, _, _ = serve(mem_engine, prompts, 16, "gpt2-small int4 "
                              "muxq_smooth, in-memory artifact")
    dreqs, drep, dlaunch, dsecs = serve(disk_engine, prompts, 16,
                                        "gpt2-small int4 muxq_smooth, saved bundle")
    if [r.out_tokens for r in dreqs] != [r.out_tokens for r in mreqs]:
        raise AssertionError("the saved bundle serves other streams than the "
                             "in-memory artifact")
    for key in ("tokens_out", "decode_steps", "prefill_steps", "prefill_chunks",
                "prefix_hits", "cow_copies", "preemptions"):
        if drep[key] != mrep[key]:
            raise AssertionError(f"bundle serve counter {key}: {drep[key]} vs "
                                 f"{mrep[key]} in memory")
    for key in ("rowwise_quantize", "muxq_gemm", "paged_attention[int4]"):
        if dlaunch[key] <= 0:
            raise AssertionError(f"bundle serve never launched {key}: {dlaunch}")
    main_runs["gpt2-small int4 muxq_smooth bundle"] = dlaunch
    # in situ, as gate (a): the fused kernels against their plain versions on
    # one 2-slot prefill chunk on int4 pages, every other input identical
    def int4_chunk(fused):
        pool = PagePool(cfg, 2, 64, page_size=ps, mode="int4",
                        kv_calib=lart.kv_calib, device=dev)
        prev = dispatch.set_fused_impl(fused)
        try:
            with torch.no_grad():
                out, _ = T.prefill_chunk_paged(cfg, disk_engine.params, toks,
                                               pool.kv, cal_table, zero2, zero2,
                                               full32, disk_engine.ctx)
        finally:
            dispatch.set_fused_impl(prev)
        return out[..., :cfg.vocab_size]
    lk6 = int4_chunk("auto")
    if not (torch.isfinite(lk6).all() and torch.equal(lk6, int4_chunk("ref"))):
        raise AssertionError("bundle serve: fused kernels change the logits "
                             "in situ")
    print("bundle serve: streams and counters equal to the in-memory "
          "artifact's; fused kernels bit-equal to their plain versions in "
          f"situ (int4 pages)  [{card}]", flush=True)
    report["bundle_serve"] = {"seconds": dsecs, "launches": dlaunch,
                              "bundle_files": bundle_files, "meta": lart.meta,
                              "tokens_out": drep["tokens_out"],
                              "decode_steps": drep["decode_steps"],
                              "prefill_steps": drep["prefill_steps"]}
    del mem_engine, disk_engine, sart, lart, params
    torch.cuda.empty_cache()
    phases.done("write, load and serve a bundle")

    # -- 9. the serving launcher, in-process -------------------------------------
    launch_json = out_dir / "launch_serve.json"
    reset_counts()
    torch.cuda.synchronize()
    rc = launch_serve.main(["--backend", "fused", "--quant", "muxq",
                            "--kv-mode", "int4", "--spec-mode", "ngram",
                            "--json-out", str(launch_json),
                            "--device", str(dev)])
    torch.cuda.synchronize()
    llaunch = read_counts()
    lrep = json.loads(launch_json.read_text())["report"]
    if rc != 0 or lrep["tokens_out"] <= 0:
        raise AssertionError(f"launcher: rc {rc}, {lrep['tokens_out']} tokens")
    for key in ("rowwise_quantize", "muxq_gemm", "paged_attention[int4]"):
        if llaunch[key] <= 0:
            raise AssertionError(f"launcher never launched {key}: {llaunch}")
    print(f"launcher: {lrep['tokens_out']} tokens, {lrep['decode_steps']} decode "
          f"steps ({lrep['spec_verify_steps']} verify) on int4 pages; launches "
          f"{llaunch}  [{card}]", flush=True)
    report["launcher"] = {"launches": llaunch, "tokens_out": lrep["tokens_out"],
                          "decode_steps": lrep["decode_steps"],
                          "spec_verify_steps": lrep["spec_verify_steps"]}
    phases.done("launcher")

    # -- 10. end to end: qwen2-0.5b at full width, int4 pages + speculation ------
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

    # -- 11-12. the other dense decoders served at full width -------------------
    def plant(c, params_, seed):
        """Seeded outliers in random weights: 8 RMSNorm gain channels x20
        (activation outliers for MUXQ's masks) and two K channels of wqkv
        x20 (KV outliers for int4 pages' redistribution)."""
        hot_ = torch.randperm(c.d_model,
                              generator=torch.Generator().manual_seed(seed)
                              )[:8].to(dev)
        k0_ = c.n_heads * c.head_dim
        k_hot_ = [k0_ + 5, k0_ + c.head_dim * (c.n_kv_heads - 1)
                  + (c.head_dim // 2 + 5) % c.head_dim]
        for lp in params_["layers"]:
            lp["ln1"]["gain"][hot_] = 19.0      # RMSNorm (1 + gain): x20
            lp["ln2"]["gain"][hot_] = 19.0
            lp["attn"]["wqkv"][:, k_hot_] *= 20.0

    def _leaves(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
            return
        for v_ in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v_)

    def wide_artifact(c, label):
        """Seeded weights at full width and cut depth, calibrated through
        the dense forward (two 2 x 64-token batches) and packed under the
        fused-MUXQ policy with the int4 KV calibration."""
        t0 = time.perf_counter()
        params_ = T.init_params(c, seed=0, device=dev)
        plant(c, params_, 3)
        batches_ = [{"tokens": torch.randint(
            0, c.vocab_size, (2, 64),
            generator=torch.Generator().manual_seed(20 + i)).numpy()}
            for i in range(2)]
        stats_, calib_ = calibrate_model(c, params_, batches_, device=dev)
        t1 = time.perf_counter()
        art_ = build_artifact(c, params_, policy, stats_.masks(),
                              kv_calib=calib_)
        t2 = time.perf_counter()
        n_par = sum(t.numel() for t in _leaves(params_))
        runs_ = sum(1 for b_ in art_.kernel_buffers.values()
                    if int((b_["block_scale"] > 1).sum()))
        n_kv = int(calib_["k_mask"].sum() + calib_["v_mask"].sum())
        print(f"{label}: {c.n_layers} layers at full width, {n_par / 1e9:.3f} "
              f"G f32 parameters ({4 * n_par / 2**30:.2f} GiB on the card); "
              f"init + calibrate {t1 - t0:.1f} s, pack "
              f"{len(art_.kernel_buffers)} sites {t2 - t1:.1f} s; {runs_} "
              f"sites carry a 2^e run, {n_kv} KV outlier channels; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB", flush=True)
        if not runs_ or not n_kv:
            raise AssertionError(f"{label}: no outlier run or KV outlier")
        return params_, art_, calib_

    ctoks = {}

    def step_logits(c, params_, ctx_, mode, kv_calib=None, fused="auto",
                    paged="auto", verify=False, nudge=None):
        """Logits of a 2-slot 32-token prefill chunk, then of one decode
        step (or a k = 4 verify block) from that pool: the in-situ gates.
        ``nudge``: the plain paged version with its outputs moved one ulp
        (a seed; implies ``paged="ref"``)."""
        if c.name not in ctoks:
            gg = torch.Generator().manual_seed(8)
            ctoks[c.name] = tuple(torch.randint(
                0, c.vocab_size, shape, generator=gg,
                dtype=torch.int32).to(dev) for shape in ((2, 32), (2, 4)))
        toks_, block_ = ctoks[c.name]
        pool = PagePool(c, 2, 64, page_size=ps, mode=mode, dtype=torch.float32,
                        kv_calib=kv_calib, device=dev)
        prev = (dispatch.set_fused_impl(fused),
                PA.set_paged_impl("ref" if nudge else paged))
        plain = PA.paged_attention_plain
        if nudge is not None:
            PA.paged_attention_plain = nudged(plain, nudge)
        try:
            with torch.no_grad():
                lp_, _ = T.prefill_chunk_paged(c, params_, toks_, pool.kv,
                                               cal_table, zero2, zero2, full32,
                                               ctx_)
                if verify:
                    ld_, _ = T.decode_verify_paged(
                        c, params_, block_, pool.kv, cal_table, full32,
                        torch.full((2,), 4, dtype=torch.int32, device=dev),
                        ctx_)
                else:
                    ld_, _ = T.decode_step_paged(c, params_, block_[:, :1],
                                                 pool.kv, cal_table, full32,
                                                 ctx_)
        finally:
            dispatch.set_fused_impl(prev[0])
            PA.set_paged_impl(prev[1])
            PA.paged_attention_plain = plain
        return lp_[..., :c.vocab_size], ld_[..., :c.vocab_size]

    class ExpertLog:
        """Records the router's top-k choices (``moe._top_k``) while
        installed; a dense model records none."""

        def __enter__(self):
            self.picks, self.orig = [], MOE._top_k

            def spy(probs, k):
                vals, idx = self.orig(probs, k)
                self.picks.append(idx)
                return vals, idx
            MOE._top_k = spy
            return self

        def __exit__(self, *exc):
            MOE._top_k = self.orig

    def in_situ(c, params_, ctx_, mode, kv_calib, label, verify=False):
        """(a) the fused kernels against their plain versions, everything
        else shared: bit-equal logits.  At fp weights, the paged kernel
        against its plain version: (b) on f32 pages, where only the
        attention sums' order differs, within LOGIT_RTOL of the logit
        scale; (b') on the served ``mode`` pages, where an ulp of K or V
        flips a code on a rounding boundary and later layers carry the
        flip, within NUDGE_FACTOR x the spread of the plain version
        against itself with every attention output nudged one ulp."""
        with ExpertLog() as la:
            ka = step_logits(c, params_, ctx_, mode, kv_calib, verify=verify)
        with ExpertLog() as lr:
            kr = step_logits(c, params_, ctx_, mode, kv_calib, fused="ref",
                             verify=verify)
        if not all(torch.isfinite(x).all() and torch.equal(x, y)
                   for x, y in zip(ka, kr)):
            raise AssertionError(f"{label} (a): the fused kernels change the "
                                 "logits in situ")
        if len(la.picks) != len(lr.picks) or not all(
                torch.equal(x, y) for x, y in zip(la.picks, lr.picks)):
            raise AssertionError(f"{label} (a): the kernel path routes a "
                                 "token to other experts than the plain path")
        n_picks = sum(x.numel() for x in la.picks)
        if n_picks:
            print(f"logits {label}: (a) {n_picks} expert choices ({c.top_k} a "
                  f"token, every layer) equal on the kernel and plain paths",
                  flush=True)

        def gap(xs, ys):
            return max(float((x - y).abs().max()) for x, y in zip(xs, ys))
        fk = step_logits(c, params_, FpCtx(), "fp", verify=verify)
        fr = step_logits(c, params_, FpCtx(), "fp", paged="ref", verify=verify)
        err_b = [float((x - y).abs().max()) for x, y in zip(fk, fr)]
        scales = [float(y.abs().max()) for y in fr]
        qk_ = step_logits(c, params_, FpCtx(), mode, kv_calib, verify=verify)
        qr_ = step_logits(c, params_, FpCtx(), mode, kv_calib, paged="ref",
                          verify=verify)
        err_q = gap(qk_, qr_)
        spreads = [gap(step_logits(c, params_, FpCtx(), mode, kv_calib,
                                   verify=verify, nudge=seed_), qr_)
                   for seed_ in (1, 2, 3)]
        step = "verify block" if verify else "decode step"
        print(f"logits {label}: (a) fused kernels bit-equal to their plain "
              f"versions on the prefill chunk and the {step} ({mode} pages); "
              f"fp weights, paged kernel vs plain: (b) f32 pages max abs err "
              f"{err_b[0]:.3e} / {err_b[1]:.3e} (|logits| max "
              f"{scales[0]:.3f} / {scales[1]:.3f}, tolerance {LOGIT_RTOL} x "
              f"max); (b') {mode} pages max abs err {err_q:.3e}, plain vs "
              f"plain with 1-ulp nudges {[round(x, 5) for x in spreads]} "
              f"(gate: <= {NUDGE_FACTOR} x max)  [{card}]", flush=True)
        if any(e > LOGIT_RTOL * s_ for e, s_ in zip(err_b, scales)):
            raise AssertionError(f"{label} (b): the paged kernel disagrees "
                                 "with the plain version on f32 pages")
        if err_q > NUDGE_FACTOR * max(spreads):
            raise AssertionError(f"{label} (b'): kernel vs plain on {mode} "
                                 f"pages {err_q} exceeds {NUDGE_FACTOR} x the "
                                 f"1-ulp spread {max(spreads)}")
        return {"fp_weights_f32_pages_max_abs_err": err_b,
                "logits_scale": scales, "expert_choices_equal": n_picks,
                f"fp_weights_{mode}_pages_max_abs_err": err_q,
                "nudge_spreads": spreads}

    wprompts = ["The quantized model serves every request through paged "
                "attention on the card.", "one int8 GEMM",
                "Outlier channels are shifted down by a power of two.",
                "Chunked prefill interleaves with the pooled decode."]

    # -- 11. qwen2.5-14b: untied head, GQA g 5, dh 128, int8 pages ---------------
    q14 = get_config("qwen2.5-14b").replace(n_layers=Q14_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    p14, a14, c14 = wide_artifact(q14, "qwen2.5-14b")
    e14 = ServeEngine(q14, a14, max_batch=4, s_max=256, prefill_chunk=32,
                      kv_mode="int8", device=dev)
    gates14 = in_situ(q14, e14.params, e14.ctx, "int8", None, "qwen2.5-14b")
    # (c) the head is lm_head: the same model read with a tied head differs
    untied = step_logits(q14, e14.params, FpCtx(), "int8")[0]
    tied = step_logits(q14.replace(tie_embeddings=True), e14.params, FpCtx(),
                       "int8")[0]
    head_gap = float((untied - tied).abs().max())
    if not head_gap > 0.1 * float(untied.abs().max()):
        raise AssertionError(f"qwen2.5-14b (c): logits through embed^T within "
                             f"{head_gap} of the lm_head logits")
    print(f"qwen2.5-14b (c): logits through lm_head differ from x @ embed^T "
          f"by up to {head_gap:.3f}", flush=True)
    r14, rep14, l14, s14 = serve(e14, wprompts, 16, "qwen2.5-14b int8 (4 of 48 "
                                 "layers, full width)")
    for key in ("rowwise_quantize", "muxq_gemm", "paged_attention[int8]"):
        if l14[key] <= 0:
            raise AssertionError(f"qwen2.5-14b serve never launched {key}: {l14}")
    main_runs["qwen2.5-14b int8"] = l14
    report["serve_qwen2_5_14b"] = {
        "layers": q14.n_layers, "seconds": s14, "launches": l14,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "head_gap": head_gap, **gates14,
        "report": {k_: v_ for k_, v_ in rep14.items() if k_ != "decode_buckets"},
        "streams": [r.out_tokens for r in r14]}
    del p14, a14, c14, e14, untied, tied
    torch.cuda.empty_cache()
    phases.done("serve qwen2.5-14b")

    # -- 12. gemma2-9b: dh 224, window 4096, softcaps, sandwich norms, int4 + ngram
    g9 = get_config("gemma2-9b").replace(n_layers=G9_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    p9, a9, c9 = wide_artifact(g9, "gemma2-9b")
    e9 = ServeEngine(g9, a9, max_batch=4, s_max=256, prefill_chunk=32,
                     kv_mode="int4", spec_mode="ngram", spec_k=4, device=dev)
    gates9 = in_situ(g9, e9.params, e9.ctx, "int4", c9, "gemma2-9b",
                     verify=True)
    # served with the sandwich post-norms' gains at SERVE_BRANCH_SCALE (the
    # residual stream then follows the scaled embedding and the greedy
    # stream repeats, so n-gram drafts match); the packed sites are unchanged
    for lp in e9.params["layers"]:
        lp["ln1b"]["gain"].fill_(SERVE_BRANCH_SCALE - 1.0)
        lp["ln2b"]["gain"].fill_(SERVE_BRANCH_SCALE - 1.0)
    if float(e9.pool.kv["k_redist"].max()) <= 1.0:
        raise AssertionError("gemma2 int4 pool runs with identity redistribution")
    r9, rep9, l9, s9 = serve(e9, qprompts, 16, "gemma2-9b int4 + ngram spec (2 "
                             "of 42 layers, full width)")
    for key in ("rowwise_quantize", "muxq_gemm", "paged_attention[int4]"):
        if l9[key] <= 0:
            raise AssertionError(f"gemma2 serve never launched {key}: {l9}")
    if rep9["spec_verify_steps"] <= 0:
        raise AssertionError("gemma2: the speculative verify step never ran")
    print(f"gemma2-9b serve: {rep9['spec_verify_steps']} verify steps, "
          f"{rep9['spec_accepted']} of {rep9['spec_proposed']} drafts "
          f"accepted, {rep9['prefix_hits']} prefix hits", flush=True)
    main_runs["gemma2-9b int4 spec"] = l9
    report["serve_gemma2_9b"] = {
        "layers": g9.n_layers, "seconds": s9, "launches": l9,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **gates9,
        "report": {k_: v_ for k_, v_ in rep9.items() if k_ != "decode_buckets"},
        "streams": [r.out_tokens for r in r9]}
    del p9, a9, c9, e9
    torch.cuda.empty_cache()
    phases.done("serve gemma2-9b")

    # -- 13. the MoE expert sites at full width -----------------------------------
    # dispatch.fused_emm at llama4-scout's and dbrx's expert sites: E 16
    # experts of C rows each (decode: 4 tokens in one flat group, the
    # dropless pad of 8; prefill: 4 slots x a 32-token chunk, one group a
    # slot, folded into C = 4 x 32), on per-expert buffers built on the
    # card; one quantize over the E*C rows, one GEMM per expert
    moe_wide = {a: get_config(a) for a in MOE_ARCHS}

    def device_experts(k, n, n_e, seed):
        """A per-expert site's served buffer built on the card: the
        channel map of 8 outlier channels at e = 2, shared by the experts,
        random k-major int8 slabs W^T [E, n, K_pad] and scales [E, 1, n]."""
        g_ = torch.Generator().manual_seed(seed)
        mask = np.zeros(k, bool)
        mask[torch.randperm(k, generator=g_)[:8].numpy()] = True
        meta = ops.prepare_weights(np.zeros((k, 1), np.float32), mask, 2,
                                   bk=512)
        k_pad = meta.gather_idx.shape[0]
        gd = torch.Generator(device=dev).manual_seed(seed)
        wt = torch.randint(-127, 128, (n_e, n, k_pad), generator=gd,
                           device=dev, dtype=torch.int8)
        sw = torch.rand(n_e, 1, n, generator=gd, device=dev) * 1e-3 + 1e-4
        return mask, {"w_int": wt.transpose(1, 2), "sw": sw,
                      "block_scale": meta.block_scale.to(dev),
                      "gather_idx": meta.gather_idx.to(dev),
                      "in_scale": meta.in_scale.to(dev)}

    n_expert_sites = 0
    for arch, c in moe_wide.items():
        n_e = c.n_experts
        cs = (MOE._capacity(c, 4), 4 * MOE._capacity(c, 32))
        for base, (k, n) in (("moe_up", (c.d_model, 2 * c.d_ff)),
                             ("moe_down", (c.d_ff, c.d_model))):
            mask, buf = device_experts(k, n, n_e, 500 + n_expert_sites)
            n_expert_sites += 1
            k_pad = buf["w_int"].shape[1]
            mws = [dispatch.as_muxq_weights(
                {**buf, "w_int": buf["w_int"][e], "sw": buf["sw"][e]})
                for e in range(n_e)]
            for cap in cs:
                x = torch.randn(n_e, cap, k, generator=gen).to(dev)
                x[..., torch.from_numpy(mask)] *= 40.0
                yk = dispatch.fused_emm(x, buf)
                prev = dispatch.set_fused_impl("ref")
                try:
                    yp = dispatch.fused_emm(x, buf)
                finally:
                    dispatch.set_fused_impl(prev)
                torch.cuda.synchronize()
                if not (torch.isfinite(yk).all() and torch.equal(yk, yp)):
                    raise AssertionError(
                        f"fused_emm {arch} {base} E={n_e} C={cap}: not "
                        f"bit-equal to the plain per-expert path (max abs "
                        f"err {float((yk - yp).abs().max())})")
                record("rowwise_quantize", site=f"{arch} {base} experts",
                       m=n_e * cap, k=k, k_pad=k_pad, max_abs_err=0.0)
                record("muxq_gemm", site=f"{arch} {base} experts", m=cap,
                       experts=n_e, k_pad=k_pad, n=n, max_abs_err=0.0)
                xq, sxq = RQ.rowwise_quantize(
                    x.reshape(n_e * cap, k), 8, gather_idx=buf["gather_idx"],
                    in_scale=buf["in_scale"])
                xq_pad = [padded_rows(xq[e * cap:(e + 1) * cap])
                          for e in range(n_e)]   # outside the timed calls

                def gemms(xq=xq, sxq=sxq, mws=mws, cap=cap):
                    return [G.muxq_gemm(xq[e * cap:(e + 1) * cap], mw.w_int,
                                        mw.block_scale,
                                        sxq[e * cap:(e + 1) * cap], mw.sw,
                                        bk=mw.bk)
                            for e, mw in enumerate(mws)]

                def plains(xq=xq, sxq=sxq, mws=mws, cap=cap):
                    return [G.muxq_gemm_plain(
                        xq[e * cap:(e + 1) * cap], mw.w_int, mw.block_scale,
                        sxq[e * cap:(e + 1) * cap], mw.sw, mw.bk)
                        for e, mw in enumerate(mws)]

                def int_mms(xq_pad=xq_pad, mws=mws):
                    return [torch._int_mm(xe, mw.w_int)
                            for xe, mw in zip(xq_pad, mws)]
                row = {"kernel": "muxq_gemm", "model": arch, "site": base,
                       "experts": n_e, "m": cap, "k_pad": k_pad, "n": n}
                row["ms"], row["spread_ms"] = time_ms(torch, gemms, flush)
                row["emm_ms"], _ = time_ms(
                    torch, lambda x=x, buf=buf: dispatch.fused_emm(x, buf),
                    flush)
                row["plain_ms"] = time_ms(torch, plains, flush, iters=5)[0]
                row["int_mm_ms"] = maybe_time(torch, int_mms, flush)
                row["bound_ms"], row["bound_by"] = bound(
                    n_e * (cap * k_pad + k_pad * n + 4 * (k_pad // 512 + cap
                                                          + n)
                           + 4 * cap * n), 2 * n_e * cap * n * k_pad,
                    INT8_OPS_S)
                row["weight_stream_ms"] = n_e * k_pad * n / HBM_BYTES_S * 1e3
                report["timings"].append(row)
                print(f"experts {arch} {base} E={n_e} C={cap} K={k} "
                      f"K_pad={k_pad} N={n}: fused_emm bit-equal to the plain "
                      f"per-expert path; {n_e} x muxq_gemm {row['ms']:.4f} ms "
                      f"(spread {row['spread_ms'][0]:.4f}-"
                      f"{row['spread_ms'][1]:.4f}; plain {row['plain_ms']:.4f}"
                      f"), fused_emm (quantize + "
                      f"{n_e} GEMMs + stack) {row['emm_ms']:.4f} ms, {n_e} x "
                      f"torch._int_mm {row['int_mm_ms']} ms (M padded to "
                      f"{max(cap, INT_MM_ROWS)}), bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}; the weight stream alone "
                      f"{row['weight_stream_ms']:.4f})  [{card}]", flush=True)
            del buf, mws
    torch.cuda.empty_cache()
    print(f"kernel check: fused_emm bit-exact at {n_expert_sites} expert "
          f"sites of {len(moe_wide)} configs x C in decode/prefill", flush=True)
    phases.done("MoE expert sites")

    def decode_launches(c, params_, ctx_, mode, kv_calib):
        """The kernel launches of one decode step of the in-situ 2-slot pool
        (its prefill chunk not counted)."""
        toks_, block_ = ctoks[c.name]
        pool = PagePool(c, 2, 64, page_size=ps, mode=mode, dtype=torch.float32,
                        kv_calib=kv_calib, device=dev)
        with torch.no_grad():
            T.prefill_chunk_paged(c, params_, toks_, pool.kv, cal_table, zero2,
                                  zero2, full32, ctx_)
            torch.cuda.synchronize()
            reset_counts()
            T.decode_step_paged(c, params_, block_[:, :1], pool.kv, cal_table,
                                full32, ctx_)
            torch.cuda.synchronize()
        counts = read_counts()
        n_shared = 2 if c.shared_expert else 0
        want = {"rowwise_quantize": c.n_layers * (4 + n_shared),
                "muxq_gemm": c.n_layers * (2 + 2 * c.n_experts + n_shared)}
        for key, n_ in want.items():
            if counts[key] != n_:
                raise AssertionError(f"{c.name}: one decode step launched "
                                     f"{counts[key]} {key}, not {n_}")
        return {k_: v_ for k_, v_ in counts.items() if v_}

    def moe_serve(c, mode, spec, prompts, label):
        """Seeded weights at full width and cut depth, calibrated, fused
        MUXQ on every site (the expert sites included), the in-situ gates,
        then 4 requests x 16 tokens; prints the tokens each expert was
        routed (padding rows included), the launches of one decode step
        and the peak device memory."""
        torch.cuda.reset_peak_memory_stats()
        params_, art_, calib_ = wide_artifact(c, label)
        kw = dict(spec_mode="ngram", spec_k=4) if spec else {}
        eng = ServeEngine(c, art_, max_batch=4, s_max=256, prefill_chunk=32,
                          kv_mode=mode, device=dev, **kw)
        for site in ("layer0/moe_up", "layer0/moe_down"):
            if eng.ctx.kernel_buffers[site]["w_int"].shape[0] != c.n_experts:
                raise AssertionError(f"{label}: {site} is not per expert")
        gates = in_situ(c, eng.params, eng.ctx, mode,
                        calib_ if mode == "int4" else None, label,
                        verify=spec)
        step_launches = decode_launches(c, eng.params, eng.ctx, mode,
                                        calib_ if mode == "int4" else None)
        if spec:
            # served with the residual branches' output projections scaled
            # by SERVE_BRANCH_SCALE (their packed weight scales) and the
            # head read as the embedding's transpose: the residual stream
            # then follows the embedding, the greedy stream repeats its
            # token and n-gram drafts match (the untied random head maps
            # a token to an unrelated one); the kernels' paths unchanged
            for site, buf in eng.ctx.kernel_buffers.items():
                if site.endswith(("attn_out", "moe_down")):
                    buf["sw"].mul_(SERVE_BRANCH_SCALE)
            eng.params["lm_head"] = eng.params["embed"].T
        with ExpertLog() as log:
            reqs, rep, launches, secs = serve(eng, prompts, 16, label)
        routed = sum(torch.bincount(x.reshape(-1), minlength=c.n_experts)
                     for x in log.picks).tolist()
        for key in ("rowwise_quantize", "muxq_gemm", f"paged_attention[{mode}]"):
            if launches[key] <= 0:
                raise AssertionError(f"{label} serve never launched {key}: "
                                     f"{launches}")
        if sum(1 for r_ in routed if r_) < 2:
            raise AssertionError(f"{label}: fewer than two experts received "
                                 f"tokens {routed}")
        if spec and rep["spec_verify_steps"] <= 0:
            raise AssertionError(f"{label}: the speculative verify step "
                                 "never ran")
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = rep["decode_steps"] + rep["prefill_steps"]
        print(f"{label} serve: {rep['decode_steps']} decode steps "
              f"({rep['spec_verify_steps']} verify, {rep['spec_accepted']} of "
              f"{rep['spec_proposed']} drafts accepted), "
              f"{rep['prefill_steps']} prefill steps in {secs:.3f} s; tokens "
              f"routed to each expert over the serve's layers (padding rows "
              f"included) {routed}; one decode step launches {step_launches}; "
              f"peak device memory {peak:.2f} GiB  [{card}]", flush=True)
        out = {"layers": c.n_layers, "seconds": secs, "launches": launches,
               "steps": steps, "decode_step_launches": step_launches,
               "tokens_per_expert": routed, "peak_gib": peak, **gates,
               "report": {k_: v_ for k_, v_ in rep.items()
                          if k_ != "decode_buckets"},
               "streams": [r.out_tokens for r in reqs]}
        return out, launches

    # -- 14. llama4-scout-17b-a16e: 16 experts top-1 + shared, int8 pages --------
    l4 = get_config("llama4-scout-17b-a16e").replace(n_layers=MOE_L4_LAYERS)
    report["serve_llama4_scout"], ll4 = moe_serve(
        l4, "int8", False, wprompts,
        f"llama4-scout-17b-a16e int8 ({MOE_L4_LAYERS} of 48 layers, full width)")
    main_runs["llama4-scout-17b-a16e int8"] = ll4
    torch.cuda.empty_cache()
    phases.done("serve llama4-scout-17b-a16e")

    # -- 15. dbrx-132b: 16 experts top-4, int4 pages + ngram ---------------------
    db = get_config("dbrx-132b").replace(n_layers=MOE_DBRX_LAYERS)
    report["serve_dbrx"], ldb = moe_serve(
        db, "int4", True, qprompts,
        f"dbrx-132b int4 + ngram spec ({MOE_DBRX_LAYERS} of 40 layers, full "
        "width)")
    main_runs["dbrx-132b int4 spec"] = ldb
    torch.cuda.empty_cache()
    phases.done("serve dbrx-132b")

    # -- 16. result lines ---------------------------------------------------------
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
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
