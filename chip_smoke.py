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
16. Tensor-parallel serving over ``torch.distributed``, every rank a
   spawned gloo process on this one card (NCCL refuses two ranks on one
   device), the artifacts of phases 5, 10 and 12 handed to the ranks
   (CUDA tensors by IPC; nothing calibrated again): gpt2-small at full
   width on int8 pages at tp = 2 and 4 (6 and 3 of its 12 heads a rank),
   gemma2-9b at full width (2 layers) on int4 pages with n-gram
   speculation at tp = 2 (4 KV heads, 8 q heads and 128 000 head columns
   a rank), and qwen2-0.5b (2 KV heads) at tp = 4, the replicated
   fallback.  Every rank's stream must equal the single-device serve's
   (phases 5, 12 and 10), with the same step, speculation and
   prefix-sharing counters; the pool holds 1/tp of the global bytes a
   rank where the heads shard (all of them on the fallback); every step
   launches one paged kernel a layer; peak device memory by rank.  A
   rank's LM-head columns against the full head's matmul at gpt2's and
   gemma2's heads (bit-equal, or within LOGIT_RTOL of the logit scale);
   the paged kernel timed cold at a rank's shapes (gpt2 decode on 6
   heads, beside SDPA; gemma2 decode on 4 KV heads), planned for the
   model's heads; one gloo ``all_reduce`` of a CUDA tensor timed in each
   rank at 16 KB, 1 MB and 16 MB.
17. Training and the paper's pipeline on trained weights, gpt2-small at
   full width in f32 (``train_phase``): (a) the port's ``Trainer``, batch
   8 x 256, 200 steps, AdamW (lr 3e-3, warmup 20), one checkpoint at step
   200 under ``build/`` (restored bit-equal, then removed): every logged
   loss finite, the last below the first; the loss curve, the median step
   time over steps 50-200, tokens/s and the peak device memory printed;
   (b) 20 steps straight against 10 steps, a fresh ``Trainer`` and a
   resume to 20: final losses within RESUME_RTOL; (c) 6 channels x20
   injected (``inject_outliers``): fp perplexity on 4 held-out batches
   moves under SURGERY_RTOL; (d) calibration through ``forward`` on 2
   more held-out batches finds outlier channels; (e) the paper's Table-1
   point through ``make_eval_step`` on the fake backend (fp; naive, MUXQ,
   LLM.int8(), SmoothQuant per-tensor at W8A8 and W8A6): naive above MUXQ
   at A6; (f) a fused MUXQ artifact (``MUXQ_FUSED_SERVE``) evaluated
   through ``rowwise_quantize`` + ``muxq_gemm`` at M 2048: CE within
   EVAL_CE_RTOL of the plain versions', every site's int8 codes and
   scales equal, exactly one quantize and one GEMM a site and batch;
   ``muxq_gemm`` timed cold at that M beside ``torch._int_mm``; (g)
   ``make_prefill_step`` + 16 ``make_serve_step`` steps on 4 prompts: on
   an f32 cache (fp) every step's token is the teacher-forced argmax and
   the logits are within LOGIT_RTOL of the paged ``decode_step_paged`` on
   f32 pages; with the fused artifact on an int8 cache one quantize and
   one GEMM a site a step.
18. The SSM, hybrid and encoder-decoder families at full width and full
   depth (``families_phase``): mamba2-370m (48 layers), zamba2-1.2b (38
   mamba layers and one shared attention + MLP block used 6 times) and
   whisper-tiny (4 + 4 layers, 1500 frames), seeded weights with 8
   ``ln1`` gain channels x20 (every layer, the encoder's too), calibrated
   on 2 batches and packed into a uniform fused MUXQ artifact
   (``quantize_model``; whisper's forward carries the frames): (a) on fp weights, ``decode_step`` after a
   300-token prefill within FAMILY_DECODE_RTOL of the forward's last
   position; (b) ``make_prefill_step`` (4 x 300 tokens; whisper 4 x 8)
   and 16 ``make_serve_step`` tokens through the kernels and through
   their plain versions: the same stream, every site call's codes and
   scales equal, logits within FUSED_RTOL; (c) one quantize and one GEMM
   a site: a decode step 144 / 138 / 28 of each, the prefill 144 / 138 /
   44 (whisper's encoder adds 16); (d) both kernels bit-equal and timed
   at every site shape at M 4 and the prefill M (whisper's encoder sites
   and ``cross_kv`` at the memory's M 6000) beside ``torch._int_mm``;
   each model's seconds and peak device memory.
19. Distributed training (``dist_phase``), every rank a spawned gloo
   process on this one card, gpt2-small at full width in f32 from the
   seed-0 weights on phase 17's batches (8 x 256) and AdamW: (a) 3
   sharded steps (``parallel/spmd.py``: params and AdamW moments stored
   sharded by ``param_specs``) at mesh (data 2, model 1) and (2, 2)
   against 3 single-device steps on the same card: loss and grad_norm of
   every step within DIST_RTOL, every rank's param shards within
   DIST_PARAM_ATOL of the single-device params, each rank's bytes of
   params + mu + nu beside the global bytes, the step's host seconds; (b)
   one step's real gradients at dp 2 through ``tree_ef_compressed_psum``:
   one-shot error under EF_SHOT_RTOL, the residual under max |g| over 20
   repeats; (c) the 12 blocks as a 4-stage GPipe schedule, 4 micro-batches
   of 2 x 256, within PIPE_RTOL of the unpipelined stack, with the
   point-to-point buffers that gloo moves through host memory counted;
   (d) ``allgather_matmul`` at gpt2's ``mlp_up`` ([32, 768] x [768, 3072]
   split 4 ways) within MATMUL_RTOL of one matmul, ``hierarchical_psum`` on
   a (pod 2, data 2) mesh exact; (e) a checkpoint saved at (2, 2) restored
   bit-equal at (4, 1) and (1, 4).  No kernel runs on this path.
20. Analysis and the dry-run (``dryrun_phase``): (a) every cell of the 11
   configs x 4 shapes (``launch/specs.py``) traced by
   ``launch.dryrun.run_cell`` at the pod mesh (a fake world of 256 ranks,
   meta tensors), and qwen1.5-110b's and dbrx-132b's ``train_4k`` at two
   pods (512), in DRYRUN_WORKERS spawned processes: every cell ok, or
   skipped for the reference's reason (long_500k on the 9 archs that are
   neither SSM nor hybrid); one line a cell of roofline arithmetic on
   the H100 constants; (b) ``lower_paged_cell`` for qwen1.5-110b and
   dbrx-132b at tp 4 on int8 pages: heads sharded, 4 KV shards, a shard's
   pool bytes a quarter of the global; (c) qwen2-0.5b's ``decode_32k``
   per-rank program (batch 128 / 16 = 8, a dense bf16 KV cache of 32768
   positions, fused MUXQ on ``synthetic_qparams``'s masks) built on the
   card and run once counted: (i) the counted flops, bytes and calls of
   ``rowwise_quantize`` and ``muxq_gemm`` and their launches equal the
   meta trace's of the same program (and the sweep's cell), (ii) the next
   tokens through the kernels equal those through the plain versions;
   the median of DRYRUN_STEPS synchronized steps on CUDA events beside
   the roofline's step, and the peak device memory beside the trace's.
21. Print one JSON line with every kernel's numbers, the ``nvidia-smi``
   line, and the final ``{"ok": true, "device": ...}`` line.

``launches`` in the JSON line counts the launches of the full-width
serving runs of phases 5, 8, 10, 11, 12, 14 and 15, of every rank of
phase 16, of phase 17's fused evaluation and int8 dense-cache serve and
of phase 18's three fused serves and of phase 20's decode step (each
run starts from zero counts); the traced serve of phase 6
and the launcher's reduced-width run
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
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense), the port's one copy: HBM3 bytes/s,
# int8 tensor-core ops/s, bf16 tensor-core flop/s, float32
# (non-tensor-core) flop/s
from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_BF16 as BF16_FLOPS_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_F32 as F32_FLOPS_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_INT8 as INT8_OPS_S  # noqa: E402
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
TP_TIMEOUT_S = 600.0        # phase 16: a world of ranks, and each collective
# phase 17: gpt2-small trained at full width
TRAIN_STEPS = 200
TRAIN_BATCH, TRAIN_SEQ = 8, 256
RESUME_RTOL = 1e-4      # (b) resumed vs straight final loss: the card sums
                        # the embedding's gradient with atomics, in no fixed
                        # order
SURGERY_RTOL = 2e-3     # (c) fp perplexity moved by the outlier injection
                        # (tests/test_paper_repro.py's claim)
EVAL_CE_RTOL = 1e-5     # (f) fused evaluation, kernels vs plain versions
N_DECODE = 16           # (g) dense-cache decode steps
# phase 18: the SSM, hybrid and encoder-decoder families, full width and
# full depth
FAMILY_ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-tiny")
FAMILY_BATCH = 4
FAMILY_PROMPT = 300     # (a), and mamba2 / zamba2 prefill: one 256-step SSD
                        # chunk crossed, the second padded
FAMILY_ENC_PROMPT = 8   # whisper's prefill prompt (its memory: 1500 frames)
FAMILY_DECODE = 16      # serve steps after the prefill
FAMILY_HOT = 8          # ln1 gain channels x20 in every layer
FAMILY_DECODE_RTOL = 1e-3   # (a) fp decode vs the forward's last position,
                            # relative to max |logits|: the SSD's chunked
                            # sums against the recurrence's, the attention
                            # over the cache against the full one, over the
                            # whole depth
# phase 19: distributed training, gloo ranks sharing the card
DIST_STEPS = 3          # (a) sharded steps a mesh, against as many
                        # single-device steps (phase 17's batches and AdamW)
DIST_RTOL = 1e-5        # (a) loss and grad_norm, relative: the same f32
                        # terms summed in another order over the ranks
DIST_PARAM_ATOL = 1e-4  # (a) params after 3 steps (lr at most 4.5e-4 then;
                        # an element's Adam update is about lr)
EF_SHOT_RTOL = 0.05     # (b) the int8 sum's one-shot error, of the exact
                        # sum's abs-max (the reference test's bound)
PIPE_MICRO = 4          # (c) micro-batches of the GPipe schedule
PIPE_RTOL = 1e-5        # (c) pipelined vs unpipelined, of the output's
                        # abs-max (the same shapes on the same card)
MATMUL_RTOL = 1e-5      # (d) the ring matmul's row blocks vs one matmul,
                        # of the output's abs-max
# phase 20: analysis and the dry-run
DRYRUN_WORKERS = 4      # (a), (b): spawned processes tracing the cells
DRYRUN_MULTIPOD = ("qwen1.5-110b", "dbrx-132b")   # train_4k at 2 pods too
DRYRUN_TP_ARCHS = ("qwen1.5-110b", "dbrx-132b")   # (b) at tp 4, int8 pages
DRYRUN_TP = 4
DRYRUN_CELL = ("qwen2-0.5b", "decode_32k")        # (c) held against the card
DRYRUN_STEPS = 20       # (c) timed steps (median)


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


def tp_rank(rank, tp, src, device, jobs):
    """Phase 16's rank ``rank`` of ``tp`` (a spawned process of a gloo
    group): for each job (label, config, artifact, engine kwargs, prompts,
    tokens per request), build a ``tp``-way engine on ``device``, set the
    launch counts to 0, serve, and read them.  Every step's paged launches
    are counted on their own (one per layer expected).  Returns, per job,
    the streams, the report's counters, the counts, the pool's shard
    accounting, the serve's seconds and this process's peak device
    memory; then the time of one ``all_reduce`` at three sizes."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quantize as RQ
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False    # as in main()
    outs = []
    for label, c, served, kw, prompts, max_new in jobs:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        engine = ServeEngine(c, served, **kw, device=dev, tp=tp)
        per_step = []

        def counted(step):
            def fn(*a):
                before = sum(PA.MODE_LAUNCHES.values())
                out = step(*a)
                per_step.append(sum(PA.MODE_LAUNCHES.values()) - before)
                return out
            return fn
        engine._prefill_pool, engine._decode_pool, engine._verify_pool = (
            counted(engine._prefill_pool), counted(engine._decode_pool),
            counted(engine._verify_pool))
        reqs = [Request(p, max_new_tokens=max_new) for p in prompts]
        RQ.LAUNCHES = G.LAUNCHES = 0
        for key in PA.MODE_LAUNCHES:
            PA.MODE_LAUNCHES[key] = 0
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        engine.generate(reqs)
        if on_card:
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        counts = {"rowwise_quantize": RQ.LAUNCHES, "muxq_gemm": G.LAUNCHES,
                  **{f"paged_attention[{k}]": n
                     for k, n in PA.MODE_LAUNCHES.items()},
                  "flash_attention": 0}
        rep = engine.metrics.report()
        outs.append({
            "label": label, "streams": [r.out_tokens for r in reqs],
            "report": {k: rep[k] for k in (
                "tokens_out", "decode_steps", "prefill_steps",
                "spec_verify_steps", "spec_proposed", "spec_accepted",
                "prefix_hits", "cow_copies", "kv_shards", "cache_bytes",
                "cache_bytes_per_shard")},
            "counts": counts, "paged_per_step": per_step,
            "heads_sharded": engine.pool.heads_sharded,
            "cache_bytes": engine.pool.cache_bytes(),
            "per_shard": engine.pool.cache_bytes_per_shard(),
            "seconds": secs,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if on_card else None)})
        del engine
    # the collective alone: one all_reduce of the sizes a step sends (a
    # layer's head merge, a decode step's and a prefill chunk's logits),
    # synchronized, the mean of 10 after 3 warm-up calls
    import torch.distributed as dist
    cost = {}
    for nbytes in (16 << 10, 1 << 20, 16 << 20):
        t = torch.ones(nbytes // 4, device=dev)
        for i in range(13):
            if i == 3:
                if on_card:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
            dist.all_reduce(t)
            if on_card:
                torch.cuda.synchronize(dev)
        cost[nbytes] = (time.perf_counter() - t0) * 1e3 / 10
    outs.append({"allreduce_ms": cost})
    return outs


def train_phase(torch, dev, cfg, card, reset_counts, read_counts, flush,
                scratch: Path):
    """Phase 17: training and the paper's pipeline on trained weights, all
    on ``dev`` in f32.  Returns (the phase's report, {label: launch counts}
    of its main-path runs: the fused evaluation and the int8 dense-cache
    serve).  ``scratch`` holds the checkpoints (removed at the end)."""
    import numpy as np

    from repro_torch.checkpoint import ckpt
    from repro_torch.core.calibrate import calibrate
    from repro_torch.core.context import FpCtx, as_ctx
    from repro_torch.core.muxq import QuantConfig
    from repro_torch.core.policy import SitePolicy
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.data.synthetic import corpus
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.steps import (MUXQ_FUSED_SERVE, make_eval_step,
                                          make_prefill_step, make_serve_step)
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import init_cache
    from repro_torch.models.surgery import (inject_outliers,
                                            pick_outlier_channels)
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.quantize import quantize_model
    from repro_torch.serve.pool import PagePool
    from repro_torch.train.trainer import TrainConfig, Trainer

    rep, runs = {}, {}
    shutil.rmtree(scratch, ignore_errors=True)
    pcfg = PipelineConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    n_sites = 4 * cfg.n_layers

    # (a) train at full width ------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30    # earlier phases'
    ck_dir = scratch / "train"
    tr = Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, ckpt_dir=str(ck_dir),
                                  ckpt_every=TRAIN_STEPS, keep=1,
                                  log_every=10),
                 pcfg, AdamWConfig(lr=3e-3, warmup_steps=20,
                                   total_steps=TRAIN_STEPS), device=dev)
    step_s, inner = [], tr.step_fn

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    tr.step_fn = timed_step
    curve = []
    out = tr.run(on_step=lambda s, m: curve.append(
        {"step": s, **{k: m[k] for k in ("loss", "lr", "grad_norm")}}))
    peak = torch.cuda.max_memory_allocated() / 2**30 - held_gib
    losses = [c["loss"] for c in curve]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"training: losses {losses}")
    steady = sorted(step_s[50:])
    med = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    params = tr.params
    # where a step's time goes: 3 more steps (results dropped) under the
    # profiler; the busy share is their device time against the median
    # unprofiled step
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in tr.pipe.batch_at(0).items()}
    p_, o_ = params, tr.opt_state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            p_, o_, _ = inner(p_, o_, batch)
        torch.cuda.synchronize()
    del p_, o_
    # kernel rows only: an aten op's row also carries its kernels' time
    rows = [(e.key, e.self_device_time_total / 3e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(t for _, t in rows)
    gemm_ms = sum(t for k, t in rows if "gemm" in k.lower())
    top = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:8]
    restored, _, meta = ckpt.restore(ck_dir, TRAIN_STEPS, params)
    if ckpt.latest_step(ck_dir) != TRAIN_STEPS or meta["data"] != {
            "step": TRAIN_STEPS} or not all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(params), tree_leaves(restored))):
        raise AssertionError("training: the step-200 checkpoint does not "
                             "restore the trained params")
    ck_mb = sum(f.stat().st_size for f in ck_dir.rglob("*.npz")) / 2**20
    del tr, restored, inner
    rep["train"] = {"curve": curve, "step_ms_median_50_200": med * 1e3,
                    "tokens_per_s": tokens / med, "wall_s": out["wall_s"],
                    "wall_tokens_per_s": TRAIN_STEPS * tokens / out["wall_s"],
                    "peak_gib": peak, "held_before_gib": held_gib,
                    "checkpoint_mib": ck_mb,
                    "device_ms_per_step": dev_ms, "gemm_ms_per_step": gemm_ms,
                    "busy_share": dev_ms / (med * 1e3),
                    "top": [{"name": k[:80], "ms": t} for k, t in top]}
    shown = " ".join(f"{c['step']}:{c['loss']:.4f}" for c in curve)
    print(f"train gpt2-small (full width, f32, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps): loss {shown}; median "
          f"step {med * 1e3:.2f} ms over steps 50-{TRAIN_STEPS} "
          f"({tokens / med:.0f} tokens/s; whole run {out['wall_s']:.2f} s, "
          f"checkpoint and logging included); peak device memory of the "
          f"training {peak:.2f} GiB (over the {held_gib:.2f} GiB that "
          f"earlier phases hold); checkpoint {ck_mb:.0f} MiB  [{card}]",
          flush=True)
    print(f"profile of a train step: device {dev_ms:.2f} ms a step, "
          f"{dev_ms / (med * 1e3):.1%} of the median step; GEMM kernels "
          f"{gemm_ms:.2f} ms; top kernels (ms a step): " + "; ".join(
              f"{k[:48]} {t:.2f}" for k, t in top[:6]) + f"  [{card}]",
          flush=True)

    # (b) resume on the card --------------------------------------------------
    racfg = AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20)
    straight = Trainer(cfg, TrainConfig(steps=20, log_every=20), pcfg, racfg,
                       device=dev).run()["final_loss"]
    rd = scratch / "resume"
    Trainer(cfg, TrainConfig(steps=10, ckpt_dir=str(rd), ckpt_every=10,
                             log_every=10), pcfg, racfg, device=dev).run()
    again = Trainer(cfg, TrainConfig(steps=20, ckpt_dir=str(rd),
                                     ckpt_every=20, log_every=20),
                    pcfg, racfg, device=dev)
    if again.step != 10:
        raise AssertionError(f"resume: started at step {again.step}, not 10")
    resumed = again.run()["final_loss"]
    del again
    gap = abs(resumed - straight) / abs(straight)
    if not gap <= RESUME_RTOL:
        raise AssertionError(f"resume: final loss {resumed} vs straight "
                             f"{straight} ({gap:.3g} relative)")
    rep["resume"] = {"straight": straight, "resumed": resumed, "gap": gap}
    print(f"resume on the card: 20 steps straight, final loss {straight!r}; "
          f"10 steps, a fresh Trainer and a resume to 20: {resumed!r} "
          f"({gap:.3g} relative, limit {RESUME_RTOL})  [{card}]", flush=True)

    # (c) surgery -------------------------------------------------------------
    held = TokenPipeline(PipelineConfig(seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=777),
                         text=corpus(4000, seed=9))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in held.batch_at(i).items()} for i in range(6)]
    evals, calib = batches[:4], batches[4:]

    def mean_ce(step, p):
        return float(np.mean([float(step(p, b)) for b in evals]))

    fp_eval = make_eval_step(cfg, device=dev)
    pout = inject_outliers(cfg, params, pick_outlier_channels(cfg, 6, seed=1),
                           20.0)
    ppl_clean = math.exp(mean_ce(fp_eval, params))
    ppl_out = math.exp(mean_ce(fp_eval, pout))
    moved = abs(ppl_out - ppl_clean) / ppl_clean
    if not moved < SURGERY_RTOL:
        raise AssertionError(f"surgery: fp perplexity {ppl_clean} -> "
                             f"{ppl_out} ({moved:.3g} relative)")
    del params

    # (d) calibration -----------------------------------------------------------
    stats, masks, _ = calibrate(
        lambda p, b, ctx: T.forward(cfg, p, b["tokens"], ctx), pout, calib)
    n_out = {s: int(np.sum(m)) for s, m in sorted(masks.items())}
    if not sum(n_out.values()):
        raise AssertionError("calibration: no outlier channel found")
    rep["surgery"] = {"ppl_clean": ppl_clean, "ppl_injected": ppl_out,
                      "moved": moved, "outlier_channels": n_out}
    kinds = {}
    for s, n in n_out.items():
        kinds.setdefault(s.split("/")[-1], []).append(n)
    print(f"surgery: 6 channels x20 into the trained weights, fp perplexity "
          f"{ppl_clean:.6f} -> {ppl_out:.6f} ({moved:.3g} relative); "
          f"calibration on 2 held-out batches: outlier channels by layer "
          f"{kinds}  [{card}]", flush=True)

    # (e) the paper's Table-1 point on trained weights (fake backend) ----------
    table = {"fp": math.exp(mean_ce(fp_eval, pout))}
    for bits in (8, 6):
        for method in ("naive", "muxq", "llm_int8", "smoothquant"):
            qc = QuantConfig(method=method, act_bits=bits, weight_bits=8,
                             act_granularity="per_tensor",
                             outlier_mode="static", exp_factor=2)
            art = quantize_model(cfg, pout, stats, SitePolicy.uniform(qc),
                                 prequantize=False, device=dev)
            table[f"{method} W8A{bits}"] = math.exp(mean_ce(
                make_eval_step(cfg, quant=art, device=dev), pout))
    if not table["naive W8A6"] > table["muxq W8A6"]:
        raise AssertionError(f"table 1: naive does not rank above MUXQ at "
                             f"A6 per-tensor: {table}")
    rep["table1"] = table
    print("table 1 on trained weights (per-tensor, perplexity on 4 held-out "
          "batches of 8 x 256): " + ", ".join(
              f"{k} {v:.4f}" for k, v in table.items()) + f"  [{card}]",
          flush=True)

    # (f) the fused evaluation through the kernels ------------------------------
    fart = quantize_model(cfg, pout, stats,
                          SitePolicy.uniform(MUXQ_FUSED_SERVE), device=dev)
    fused_eval = make_eval_step(cfg, quant=fart, device=dev)

    def logged(kernels):
        """CEs of the fused evaluation and the codes every site quantized
        (the kernels' path, or with the fused impl set to the plain
        versions)."""
        codes = []
        k_rq, p_rq = ops.rowwise_quantize, kref.rowwise_quantize_ref

        def rec(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                codes.append(out)
                return out
            return wrapped
        ops.rowwise_quantize = rec(k_rq)
        kref.rowwise_quantize_ref = rec(p_rq)
        prev = dispatch.set_fused_impl("auto" if kernels else "ref")
        try:
            reset_counts()
            ces = [float(fused_eval(pout, b)) for b in evals]
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            ops.rowwise_quantize, kref.rowwise_quantize_ref = k_rq, p_rq
            dispatch.set_fused_impl(prev)
        return ces, codes, counts

    ces_k, codes_k, launches = logged(True)
    ces_p, codes_p, _ = logged(False)
    want = {"rowwise_quantize": n_sites * len(evals),
            "muxq_gemm": n_sites * len(evals)}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"fused evaluation launched {launches}, "
                             f"expected {want}")
    if len(codes_k) != len(codes_p) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(codes_k, codes_p)):
        raise AssertionError("fused evaluation: the kernels' int8 codes or "
                             "scales differ from the plain versions'")
    ce_k, ce_p = float(np.mean(ces_k)), float(np.mean(ces_p))
    if not abs(ce_k - ce_p) <= EVAL_CE_RTOL * abs(ce_p):
        raise AssertionError(f"fused evaluation: CE {ce_k} through the "
                             f"kernels vs {ce_p} plain")
    del codes_k, codes_p
    runs["gpt2-small trained: fused MUXQ evaluation"] = launches
    rep["fused_eval"] = {"ce_kernels": ces_k, "ce_plain": ces_p,
                         "ppl": math.exp(ce_k), "launches": launches}
    print(f"fused MUXQ evaluation (W8A8 per-token/per-channel, "
          f"rowwise_quantize + muxq_gemm at M {TRAIN_BATCH * TRAIN_SEQ}): "
          f"perplexity {math.exp(ce_k):.6f} (kernels) vs {math.exp(ce_p):.6f} "
          f"(plain), codes equal at all {len(ces_k) * n_sites} site calls; "
          f"fake MUXQ W8A8 per-tensor {table['muxq W8A8']:.6f}; launches "
          f"{launches}  [{card}]", flush=True)

    # muxq_gemm at the evaluation's M, one site, cold
    ctx = as_ctx(fart, dev)
    mw = dispatch.as_muxq_weights(ctx.kernel_buffers["layer0/mlp_up"])
    m = TRAIN_BATCH * TRAIN_SEQ
    k_pad, n = mw.w_int.shape
    gen = torch.Generator().manual_seed(17)
    xq = torch.randint(-127, 128, (m, k_pad), generator=gen,
                       dtype=torch.int8).to(dev)
    sx = torch.rand(m, 1, generator=gen).to(dev)
    row = {"kernel": "muxq_gemm", "model": "gpt2-small trained", "site":
           "mlp_up", "m": m, "k_pad": k_pad, "n": n}
    row["ms"], row["spread_ms"] = time_ms(torch, lambda: G.muxq_gemm(
        xq, mw.w_int, mw.block_scale, sx, mw.sw, bk=mw.bk), flush)
    row["plain_ms"] = time_ms(torch, lambda: G.muxq_gemm_plain(
        xq, mw.w_int, mw.block_scale, sx, mw.sw, mw.bk), flush)[0]
    row["int_mm_ms"] = maybe_time(torch, lambda: torch._int_mm(xq, mw.w_int),
                                  flush)
    row["bound_ms"], row["bound_by"] = bound(
        m * k_pad + k_pad * n + 4 * (k_pad // mw.bk + m + n) + 4 * m * n,
        2 * m * n * k_pad, INT8_OPS_S)
    rep["gemm_m2048"] = row
    print(f"time muxq_gemm [gpt2 mlp_up M={m} K_pad={k_pad} N={n}, cold]: "
          f"kernel {row['ms']:.4f} ms (spread {row['spread_ms'][0]:.4f}-"
          f"{row['spread_ms'][1]:.4f}), plain {row['plain_ms']:.4f} ms, "
          f"torch._int_mm {row['int_mm_ms']} ms, bound {row['bound_ms']:.5f} "
          f"ms ({row['bound_by']})  [{card}]", flush=True)

    # (g) the dense-cache serve path --------------------------------------------
    P, b = 32, 4
    prompts = evals[0]["tokens"][:b, :P]
    s_max = P + N_DECODE
    prefill = make_prefill_step(cfg, s_max, kv_dtype=torch.float32,
                                device=dev)
    serve = make_serve_step(cfg, device=dev)
    tok, cache = prefill(pout, {"tokens": prompts})
    stream = [tok]
    for _ in range(N_DECODE):
        tok, cache = serve(pout, {"tokens": tok[:, None], "cache": cache})
        stream.append(tok)
    # teacher-forced over that stream: the dense cache against f32 pages
    pool = PagePool(cfg, b, s_max, page_size=16, mode="fp",
                    dtype=torch.float32, device=dev)
    pp = pool.pages_per_slot
    table_ = torch.arange(1, 1 + b * pp, dtype=torch.int32,
                          device=dev).reshape(b, pp)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    fp = FpCtx()
    worst = 0.0
    with torch.no_grad():
        dense = T.forward(cfg, pout, prompts, fp, cache=init_cache(
            cfg, b, s_max, dtype=torch.float32, device=dev))
        paged, _ = T.prefill_chunk_paged(cfg, pout, prompts, pool.kv, table_,
                                         zeros, zeros, zeros + P, fp)
        pairs = [(dense["logits"][:, -1], paged[:, -1])]
        dcache = dense["cache"]
        for j in range(N_DECODE):
            t_ = stream[j][:, None]
            ld, dcache = T.decode_step(cfg, pout, t_, dcache, fp)
            lp, _ = T.decode_step_paged(cfg, pout, t_, pool.kv, table_,
                                        zeros + P + j, fp)
            pairs.append((ld[:, 0], lp[:, 0]))
        for j, (ld, lp) in enumerate(pairs):
            ld, lp = ld[:, :cfg.vocab_size], lp[:, :cfg.vocab_size]
            if not torch.equal(torch.argmax(ld, -1).to(torch.int32),
                               stream[j]):
                raise AssertionError(f"dense serve step {j}: its token is "
                                     "not the teacher-forced argmax")
            err = float((ld - lp).abs().max()) / float(ld.abs().max())
            worst = max(worst, err)
    if not worst <= LOGIT_RTOL:
        raise AssertionError(f"dense-cache serve: logits {worst:.3g} of "
                             f"their scale off the paged decode")
    # the fused artifact on an int8 cache: one quantize and one GEMM a site
    # a step
    prefill8 = make_prefill_step(cfg, s_max, quant=fart, kv_dtype=torch.int8,
                                 device=dev)
    serve8 = make_serve_step(cfg, quant=fart, device=dev)
    per_step, total = [], {}
    reset_counts()
    tok8, cache8 = prefill8(pout, {"tokens": prompts})
    torch.cuda.synchronize()
    per_step.append(read_counts())
    stream8 = [tok8]
    for _ in range(N_DECODE):
        reset_counts()
        tok8, cache8 = serve8(pout, {"tokens": tok8[:, None],
                                     "cache": cache8})
        torch.cuda.synchronize()
        per_step.append(read_counts())
        stream8.append(tok8)
    for c in per_step:
        if {k: v for k, v in c.items() if v} != {"rowwise_quantize": n_sites,
                                                "muxq_gemm": n_sites}:
            raise AssertionError(f"int8 dense-cache serve: a step launched "
                                 f"{c}, expected {n_sites} of each")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    if cache8["k"].dtype != torch.int8 or int(cache8["pos"]) != s_max:
        raise AssertionError("int8 dense-cache serve: the cache is not int8 "
                             f"at position {s_max}")
    s8 = torch.stack(stream8, 1)
    if not bool(((s8 >= 0) & (s8 < cfg.vocab_size)).all()):
        raise AssertionError("int8 dense-cache serve: tokens out of range")
    runs["gpt2-small trained: dense-cache int8 serve, fused MUXQ"] = total
    same = float((s8 == torch.stack(stream, 1)).float().mean())
    rep["dense_serve"] = {"max_logit_rel_gap": worst, "int8_launches": total,
                          "int8_vs_fp_token_agreement": same}
    print(f"dense-cache serve: prefill of 4 x {P} + {N_DECODE} decode steps; "
          f"f32 cache vs f32 pages (FpCtx) teacher-forced logits within "
          f"{worst:.3g} of their scale; fused MUXQ on an int8 cache: "
          f"{n_sites} quantizes and {n_sites} GEMMs a step, "
          f"{same:.3f} of its tokens equal the fp stream's  [{card}]",
          flush=True)
    shutil.rmtree(scratch, ignore_errors=True)
    return rep, runs


def families_phase(torch, dev, cfgs, card, reset_counts, read_counts, flush,
                   record, timings, phases):
    """Phase 18: the SSM, hybrid and encoder-decoder families served at
    full width and full depth from a fused MUXQ artifact, one model after
    another (``cfgs``: arch -> config).  Returns (the phase's report,
    {label: launch counts} of its main-path runs: each model's fused
    prefill and serve through the kernels)."""
    import numpy as np

    from repro_torch.core.context import FpCtx
    from repro_torch.core.policy import SitePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as RQ
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.steps import (MUXQ_FUSED_SERVE, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import n_attn_layers
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quantize import quantize_model, split_site

    rep, runs = {}, {}
    policy = SitePolicy.uniform(MUXQ_FUSED_SERVE)
    for arch, cfg in cfgs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_gib = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        fam = cfg.family
        # sites a decode step runs (one quantize and one GEMM each), and
        # those the prefill adds (the encoder's)
        per_step = {"ssm": 3 * cfg.n_layers,
                    "hybrid": 3 * cfg.n_layers + 4 * n_attn_layers(cfg),
                    "encdec": 7 * cfg.n_layers}[fam]
        prefill_sites = per_step + 4 * cfg.n_enc_layers
        s = FAMILY_ENC_PROMPT if cfg.is_enc_dec else FAMILY_PROMPT
        b = FAMILY_BATCH

        def batch_of(seed, s_):
            g_ = torch.Generator().manual_seed(seed)
            out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s_),
                                           generator=g_).to(dev)}
            if cfg.is_enc_dec:
                out["frames"] = torch.randn(
                    b, cfg.n_audio_frames, cfg.d_model, generator=g_).to(dev)
            return out

        def extra_of(batch):
            return {"frames": batch["frames"]} if cfg.is_enc_dec else None

        # seeded weights, 8 ln1 gain channels x20 in every layer (the
        # encoder's too) -------------------------------------------------------
        params = T.init_params(cfg, seed=0, device=dev)
        hot = torch.randperm(cfg.d_model, generator=torch.Generator(
        ).manual_seed(1))[:FAMILY_HOT].to(dev)
        for lp in params["layers"] + params.get("enc_layers", []):
            if cfg.norm == "rmsnorm":
                lp["ln1"]["gain"][hot] = 19.0       # (1 + gain): x20
            else:
                lp["ln1"]["gain"][hot] *= 20.0
        n_par = sum(t.numel() for t in tree_leaves(params))

        # calibrate (2 batches) and pack a uniform fused MUXQ artifact -------
        calib = [batch_of(20 + i, s) for i in range(2)]
        forward = None
        if cfg.is_enc_dec:   # the default calibration forward drops frames
            def forward(p, batch, ctx):
                return T.forward(cfg, p, batch["tokens"], ctx,
                                 extra=extra_of(batch))
        art = quantize_model(cfg, params, calib, policy, forward=forward,
                             device=dev)
        t_art = time.perf_counter() - t0
        kinds = {}
        for site in art.kernel_buffers:
            kind, _, base = split_site(site)
            kinds.setdefault(f"{kind}/{base}", 0)
            kinds[f"{kind}/{base}"] += 1
        runs_2e = sum(1 for b_ in art.kernel_buffers.values()
                      if int((np.asarray(b_["block_scale"]) > 1).sum()))
        if not runs_2e:
            raise AssertionError(f"{arch}: no site carries an outlier run")

        # (a) fp weights: decode_step against forward's last position ---------
        fa = batch_of(40, FAMILY_PROMPT + 1)
        with torch.no_grad():
            full = T.forward(cfg, params, fa["tokens"], FpCtx(),
                             extra=extra_of(fa))["logits"][:, -1]
            pre_fp = make_prefill_step(cfg, FAMILY_PROMPT + 1,
                                       kv_dtype=torch.float32, device=dev)
            _, cache = pre_fp(params, {**fa, "tokens":
                                       fa["tokens"][:, :-1]})
            dec, _ = T.decode_step(cfg, params, fa["tokens"][:, -1:], cache,
                                   FpCtx())
        scale = float(full.abs().max())
        gap_a = float((dec[:, 0] - full).abs().max()) / scale
        if not (torch.isfinite(dec).all() and gap_a <= FAMILY_DECODE_RTOL):
            raise AssertionError(f"{arch} (a): decode logits {gap_a:.3g} of "
                                 f"their scale off the forward's")
        del full, cache, dec

        # (b) fused serve, kernels and plain versions; (c) its launches -------
        prompts = batch_of(30, s)
        pre = make_prefill_step(cfg, s + FAMILY_DECODE, quant=art,
                                kv_dtype=torch.float32, device=dev)
        serve = make_serve_step(cfg, quant=art, device=dev)

        def fused_serve(kernels):
            """Tokens, last-position logits of every step, the codes and
            scales every site quantized, and each step's launches."""
            codes, logits, counts = [], [], []
            k_rq, p_rq = ops.rowwise_quantize, kref.rowwise_quantize_ref
            fwd, dstep = T.forward, T.decode_step

            def rec_q(fn):
                def wrapped(*a, **k):
                    out = fn(*a, **k)
                    codes.append(out)
                    return out
                return wrapped

            def rec_fwd(*a, **k):
                out = fwd(*a, **k)
                logits.append(out["logits"][:, -1])
                return out

            def rec_dec(*a, **k):
                out = dstep(*a, **k)
                logits.append(out[0][:, -1])
                return out
            ops.rowwise_quantize = rec_q(k_rq)
            kref.rowwise_quantize_ref = rec_q(p_rq)
            T.forward, T.decode_step = rec_fwd, rec_dec
            prev = dispatch.set_fused_impl("auto" if kernels else "ref")
            try:
                reset_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tok, cache_ = pre(params, prompts)
                torch.cuda.synchronize()
                counts.append(read_counts())
                stream = [tok]
                for _ in range(FAMILY_DECODE):
                    reset_counts()
                    tok, cache_ = serve(params, {"tokens": tok[:, None],
                                                 "cache": cache_})
                    torch.cuda.synchronize()
                    counts.append(read_counts())
                    stream.append(tok)
                secs = time.perf_counter() - t1
            finally:
                ops.rowwise_quantize, kref.rowwise_quantize_ref = k_rq, p_rq
                T.forward, T.decode_step = fwd, dstep
                dispatch.set_fused_impl(prev)
            if int(cache_["pos"]) != s + FAMILY_DECODE:
                raise AssertionError(f"{arch}: the cache ends at "
                                     f"{int(cache_['pos'])}")
            return torch.stack(stream, 1), logits, codes, counts, secs

        stream_k, logits_k, codes_k, counts_k, secs = fused_serve(True)
        stream_p, logits_p, codes_p, _, secs_p = fused_serve(False)
        if not torch.equal(stream_k, stream_p):
            raise AssertionError(f"{arch} (b): the kernels' stream "
                                 f"{stream_k.tolist()} differs from the plain "
                                 f"versions' {stream_p.tolist()}")
        if not bool(((stream_k >= 0) & (stream_k < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch} (b): tokens out of range")
        if len(codes_k) != len(codes_p) or not all(
                torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                for x, y in zip(codes_k, codes_p)):
            raise AssertionError(f"{arch} (b): the kernels' int8 codes or "
                                 "scales differ from the plain versions'")
        gap_b = max(float((x - y).abs().max()) / float(y.abs().max())
                    for x, y in zip(logits_k, logits_p))
        if len(logits_k) != FAMILY_DECODE + 1 or not gap_b <= FUSED_RTOL:
            raise AssertionError(f"{arch} (b): logits {gap_b:.3g} of their "
                                 f"scale off the plain versions'")
        n_calls = len(codes_k)
        del codes_k, codes_p, logits_k, logits_p
        want_pre = {"rowwise_quantize": prefill_sites,
                    "muxq_gemm": prefill_sites}
        want_step = {"rowwise_quantize": per_step, "muxq_gemm": per_step}
        got_pre = {k: v for k, v in counts_k[0].items() if v}
        if got_pre != want_pre:
            raise AssertionError(f"{arch} (c): the prefill launched "
                                 f"{got_pre}, expected {want_pre}")
        for c_ in counts_k[1:]:
            if {k: v for k, v in c_.items() if v} != want_step:
                raise AssertionError(f"{arch} (c): a decode step launched "
                                     f"{c_}, expected {want_step}")
        total = {}
        for c_ in counts_k:
            for k, v in c_.items():
                total[k] = total.get(k, 0) + v
        runs[f"{arch} fused MUXQ serve"] = total
        peak = torch.cuda.max_memory_allocated() / 2**30 - held_gib

        # (d) both kernels at every new site shape, served buffers ----------
        m_pre = b * s
        shapes = []
        for site in sorted(art.kernel_buffers):
            kind, idx, base = split_site(site)
            if idx != 0:
                continue
            # encoder sites and cross_kv run on the memory's rows, always
            m_mem = b * cfg.n_audio_frames
            ms = ((m_mem,) if kind == "enc" or base == "cross_kv"
                  else (4, m_pre))
            shapes += [(site, m) for m in ms]
        for site, m in shapes:
            buf = dispatch.buffer_to(art.kernel_buffers[site], dev)
            mw = dispatch.as_muxq_weights(buf)
            k_pad, n = mw.w_int.shape
            mask = np.asarray(art.masks[site], bool)
            k = len(mask)
            x = torch.randn(m, k, generator=torch.Generator().manual_seed(m + n))
            x[:, torch.from_numpy(mask)] *= 40.0
            x = x.to(dev)
            qk, sk = RQ.rowwise_quantize(x, 8, gather_idx=mw.gather_idx,
                                         in_scale=mw.in_scale)
            qp, sp = RQ.rowwise_quantize_plain(x, 8, mw.gather_idx,
                                               mw.in_scale)
            yk = G.muxq_gemm(qk, mw.w_int, mw.block_scale, sk, mw.sw,
                             bk=mw.bk)
            yp = G.muxq_gemm_plain(qk, mw.w_int, mw.block_scale, sk, mw.sw,
                                   mw.bk)
            torch.cuda.synchronize()
            if not (torch.equal(qk, qp) and torch.equal(sk, sp)
                    and torch.equal(yk, yp) and torch.isfinite(yk).all()):
                raise AssertionError(f"{arch} {site} M {m}: a kernel is not "
                                     "bit-equal to its plain version")
            record("rowwise_quantize", site=f"{arch} {site}", m=m, k=k,
                   k_pad=k_pad, max_abs_err=0.0)
            record("muxq_gemm", site=f"{arch} {site}", m=m, k_pad=k_pad, n=n,
                   max_abs_err=0.0)
            xq_pad = padded_rows(qk)        # outside the timed call
            row = {"kernel": "muxq_gemm", "model": arch, "site": site,
                   "m": m, "k": k, "k_pad": k_pad, "n": n}
            row["ms"], row["spread_ms"] = time_ms(torch, lambda: G.muxq_gemm(
                qk, mw.w_int, mw.block_scale, sk, mw.sw, bk=mw.bk), flush)
            row["plain_ms"] = time_ms(torch, lambda: G.muxq_gemm_plain(
                qk, mw.w_int, mw.block_scale, sk, mw.sw, mw.bk), flush,
                iters=5)[0]
            row["int_mm_ms"] = maybe_time(
                torch, lambda: torch._int_mm(xq_pad, mw.w_int), flush)
            row["bound_ms"], row["bound_by"] = bound(
                m * k_pad + k_pad * n + 4 * (k_pad // mw.bk + m + n)
                + 4 * m * n, 2 * m * n * k_pad, INT8_OPS_S)
            qrow = {"kernel": "rowwise_quantize", "model": arch, "site": site,
                    "m": m, "k": k, "k_pad": k_pad}
            qrow["ms"], qrow["spread_ms"] = time_ms(
                torch, lambda: RQ.rowwise_quantize(
                    x, 8, gather_idx=mw.gather_idx, in_scale=mw.in_scale),
                flush)
            qrow["plain_ms"] = time_ms(torch, lambda: RQ.rowwise_quantize_plain(
                x, 8, mw.gather_idx, mw.in_scale), flush, iters=5)[0]
            qrow["bound_ms"], qrow["bound_by"] = bound(
                4 * m * k + m * k_pad + 4 * m + 8 * k_pad, m * k_pad,
                F32_FLOPS_S)
            timings += [row, qrow]
            print(f"time {arch} {site} M {m} (K {k}, K_pad {k_pad}, N {n}; "
                  f"bit-equal): muxq_gemm {row['ms']:.4f} ms (spread "
                  f"{row['spread_ms'][0]:.4f}-{row['spread_ms'][1]:.4f}; plain "
                  f"{row['plain_ms']:.4f}), torch._int_mm {row['int_mm_ms']} "
                  f"ms (M padded to {max(m, INT_MM_ROWS)}), bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}); "
                  f"rowwise_quantize {qrow['ms']:.4f} ms (plain "
                  f"{qrow['plain_ms']:.4f}), bound {qrow['bound_ms']:.6f} ms  "
                  f"[{card}]", flush=True)
            del buf, mw, x, qk, sk, qp, sp, yk, yp, xq_pad
        secs_phase = time.perf_counter() - t0
        rep[arch] = {
            "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
            "d_model": cfg.d_model, "params_g": n_par / 1e9,
            "artifact_s": t_art, "sites": len(art.kernel_buffers),
            "sites_by_kind": kinds, "sites_with_2e_run": runs_2e,
            "decode_vs_forward_rel": gap_a, "fused_vs_plain_logit_rel": gap_b,
            "site_calls_equal": n_calls, "stream": stream_k.tolist(),
            "serve_s": secs, "serve_plain_s": secs_p,
            "prefill_launches": got_pre, "decode_step_launches": want_step,
            "launches": total, "peak_gib": peak, "held_before_gib": held_gib,
            "phase_s": secs_phase}
        print(f"{arch} ({fam}; {cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers
                 else "") + f", d {cfg.d_model}, full width and depth, "
              f"{n_par / 1e9:.3f} G f32 parameters): artifact of "
              f"{len(art.kernel_buffers)} fused sites {kinds} ({runs_2e} with "
              f"a 2^e run) in {t_art:.1f} s; (a) fp decode after a "
              f"{FAMILY_PROMPT}-token prefill within {gap_a:.3g} of the "
              f"forward's logit scale; (b) prefill {b} x {s} + "
              f"{FAMILY_DECODE} serve steps {secs:.3f} s (plain versions "
              f"{secs_p:.3f} s), the same stream, codes and scales equal at "
              f"all {n_calls} site calls, logits {gap_b:.3g} apart; (c) the "
              f"prefill launches {got_pre}, every decode step {want_step}; "
              f"peak device memory {peak:.2f} GiB over {held_gib:.2f} held; "
              f"phase {secs_phase:.1f} s  [{card}]", flush=True)
        del params, art, pre, serve, pre_fp, calib, prompts, fa
        torch.cuda.empty_cache()
        phases.done(f"serve {arch}")
    return rep, runs


def _dist_steps(torch, cfg, mesh, batches, acfg, dev_):
    """3 sharded steps of gpt2 from the seed-0 weights on ``mesh``: the
    metrics, each step's host seconds (synchronized), and the state."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import spmd
    params = T.init_params(cfg, 0, device=dev_)
    specs, dparams, state = spmd.init_sharded(cfg, params, mesh)
    del params
    step = spmd.make_sharded_train_step(cfg, mesh, specs, acfg, device=dev_)
    metrics, secs = [], []
    for batch in batches:
        if dev_.type == "cuda":
            torch.cuda.synchronize(dev_)
        t0 = time.perf_counter()
        dparams, state, m = step(dparams, state, batch)
        if dev_.type == "cuda":
            torch.cuda.synchronize(dev_)
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return specs, dparams, state, metrics, secs


def dist_rank(rank, world, src, device_name, job):
    """Phase 19's rank ``rank`` of ``world`` (a spawned gloo process on
    the one card).  Every world: 3 sharded gpt2 steps at its mesh, each
    rank's shards held against the single-device step's params (handed
    over by CUDA IPC).  World 2 also sums one step's real gradients
    through the int8 error-feedback all-reduce; world 4 also saves and
    restores the sharded checkpoint, runs the GPipe schedule, the ring
    matmul and the hierarchical sum.  Returns the numbers; the parent
    gates them."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.context import FpCtx
    from repro_torch.launch import mesh as M
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, compress
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import global_stats as GS
    from repro_torch.parallel import pipeline as PP
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import spmd

    dev_ = torch.device(device_name)
    on_card = dev_.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False    # as in main()
    cfg, batches, acfg = job["cfg"], job["batches"], job["acfg"]
    out = {}
    shape = (2, 1) if world == 2 else (2, 2)
    mesh = M.make_host_mesh(*shape, device=device_name)
    coord = SH.coordinate(mesh)

    if world == 2:   # (b) one step's real gradients, compressed at dp 2
        params = T.init_params(cfg, 0, device=dev_)
        local = {k: SH.local_shard(torch.as_tensor(v, device=dev_),
                                   SH.batch_specs(mesh, batches[0])[k], mesh)
                 for k, v in batches[0].items()}
        dp_group = C.subgroup(mesh, ("data",))
        with GS.data_parallel(dp_group):
            _, _, grads = loss_and_grads(cfg, params, local, FpCtx())
        del params
        exact = adamw.tree_map(
            lambda g: C.all_reduce(g.clone(), "sum", dp_group), grads)
        err = compress.init_error_state(grads)
        tot, err = compress.tree_ef_compressed_psum(grads, err, dp_group)
        rel = max(float((t - e).abs().max() / e.abs().max().clamp_min(1e-30))
                  for t, e in zip(adamw.tree_leaves(tot),
                                  adamw.tree_leaves(exact)))
        g_max = [float(g.abs().max()) for g in adamw.tree_leaves(grads)]
        worst = 0.0   # the residual's abs-max over |g|'s, 20 repeats
        for _ in range(20):
            tot, err = compress.tree_ef_compressed_psum(grads, err, dp_group)
            worst = max(worst, max(float(e.abs().max()) / max(m_, 1e-30)
                                   for e, m_ in zip(adamw.tree_leaves(err),
                                                    g_max)))
        out["ef"] = {"one_shot_rel": rel, "residual_over_g": worst,
                     "leaves": len(g_max)}
        del grads, exact, err, tot

    # (a) 3 sharded steps against the single-device step's params
    specs, dparams, state, metrics, secs = _dist_steps(
        torch, cfg, mesh, batches, acfg, dev_)
    gap = 0.0
    for p_, ref, spec in zip(adamw.tree_leaves(dparams),
                             adamw.tree_leaves(job["ref_params"]),
                             spmd.spec_leaves(specs)):
        want = SH.local_shard(ref, spec, mesh, coord)
        loc = p_.to_local()
        if loc.shape != want.shape:
            raise AssertionError(f"rank {rank}: shard {tuple(loc.shape)} != "
                                 f"{tuple(want.shape)}")
        gap = max(gap, float((loc - want).abs().max()))
    out.update(metrics=metrics, step_s=secs, param_gap=gap, coord=coord,
               local_bytes=spmd.local_bytes([dparams, state["mu"],
                                             state["nu"]]),
               global_bytes=spmd.global_bytes([dparams, state["mu"],
                                               state["nu"]]),
               peak_gib=(torch.cuda.max_memory_allocated(dev_) / 2**30
                         if on_card else None))
    if world == 2:
        return out

    # (e) the checkpoint: saved at (2, 2), restored at (4, 1) and (1, 4)
    full = SH.gather_tree(dparams)
    mu = SH.gather_tree(state["mu"])
    t0 = time.perf_counter()
    ckpt.save(job["ckpt_dir"], 3, dparams, state)
    out["ckpt_save_s"] = time.perf_counter() - t0
    del dparams, state
    template = T.init_params(cfg, 1, device=dev_)
    equal = True
    for shape2 in ((4, 1), (1, 4)):
        m2 = M.make_host_mesh(*shape2, device=device_name)
        sp2 = SH.param_specs(cfg, template, m2)
        p2, o2, _ = ckpt.restore(job["ckpt_dir"], 3, template,
                                 adamw.init_state(template), shardings=sp2,
                                 opt_shardings={"mu": sp2, "nu": sp2},
                                 mesh=m2)
        for tree, whole in ((p2, full), (o2["mu"], mu)):
            for d_, w_, s_ in zip(adamw.tree_leaves(tree),
                                  adamw.tree_leaves(whole), spmd.spec_leaves(sp2)):
                equal &= torch.equal(d_.to_local(),
                                     SH.local_shard(w_, s_, m2))
        del p2, o2
    out["ckpt_equal"] = equal
    del full, mu, template

    # (c) the GPipe schedule: 12 blocks in 4 stages of 3, 4 micro-batches
    params = T.init_params(job["pipe_cfg"], 0, device=dev_)
    x_micro = job["pipe_x"]
    pos = torch.arange(x_micro.shape[2], device=dev_)[None].expand(
        x_micro.shape[1], -1)

    def block_fn(layers, h):
        for i, lp in layers:
            h, _ = T._block(cfg, lp, T._Named(FpCtx(), f"layer{i}/"), h,
                            lambda p, c, x: A.attention(cfg, p, c, x, pos))
        return h

    stages = PP.split_stages(list(enumerate(params["layers"])), world)
    before = dict(C.HOST_COPIES)
    with torch.no_grad():
        t0 = time.perf_counter()
        y = PP.pipeline_apply(block_fn, stages[rank], x_micro)
        if on_card:
            torch.cuda.synchronize(dev_)
        out["pipe_s"] = time.perf_counter() - t0
    out["pipe_gap"] = float((y - job["pipe_ref"]).abs().max())
    out["pipe_scale"] = float(job["pipe_ref"].abs().max())
    out["pipe_host_copies"] = {k: C.HOST_COPIES[k] - before[k]
                               for k in before}
    del params, y

    # (d) the ring matmul at gpt2's mlp_up, the hierarchical sum on 2 x 2
    x, w = job["mm_x"], job["mm_w"]
    m_, n_ = x.shape[0] // world, w.shape[1] // world
    before = dict(C.HOST_COPIES)
    yl = C.allgather_matmul(x[rank * m_:(rank + 1) * m_],
                            w[:, rank * n_:(rank + 1) * n_].contiguous())
    want = x @ w[:, rank * n_:(rank + 1) * n_]
    out["mm_gap"] = float((yl - want).abs().max())
    out["mm_scale"] = float(want.abs().max())
    out["mm_host_copies"] = {k: C.HOST_COPIES[k] - before[k] for k in before}
    pod_data = M.make_mesh((2, 2), ("pod", "data"), device=device_name)
    c_ = SH.coordinate(pod_data)
    hx = job["hier_x"][c_["pod"], c_["data"]]
    hs = C.hierarchical_psum(hx, pod_data.get_group("data"),
                             pod_data.get_group("pod"))
    out["hier_equal"] = torch.equal(hs, job["hier_x"].sum((0, 1)))
    return out


def _kernel_label(name: str) -> str:
    """A profiler row's kernel name, short: the functor of PyTorch's
    elementwise kernels (``direct_copy_kernel_cuda``), else the first 40
    characters."""
    m = re.search(r"native::(?:\(anonymous namespace\)::)?(\w+)\(", name)
    return m.group(1) if m else name[:40]


def event_times(torch, fn, n: int):
    """Milliseconds of ``n`` calls of ``fn`` on CUDA events, each call
    synchronized (the host's work between the launches included), after
    3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def dist_phase(torch, dev, cfg, card, scratch: Path):
    """Phase 19: distributed training on gloo ranks sharing ``dev`` (NCCL
    refuses two ranks on one device).  Returns the phase's report."""
    from repro_torch.core.context import FpCtx
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.ranks import run_ranks

    rep = {}
    shutil.rmtree(scratch, ignore_errors=True)
    pipe = TokenPipeline(PipelineConfig(seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    batches = [pipe.batch_at(i) for i in range(DIST_STEPS)]
    acfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=TRAIN_STEPS)

    # the single-device step on the same card and batches
    params = T.init_params(cfg, 0, device=dev)
    state = init_state(params)
    step = make_train_step(cfg, acfg, device=dev)
    single, single_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, {
            k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t0)
        single.append({k: float(v) for k, v in m.items()})
    del state

    # the pipeline's input and its unpipelined reference, micro-batch by
    # micro-batch (the shapes the stages run)
    tokens = torch.as_tensor(batches[0]["tokens"], device=dev)
    # gpt2-small's 12 layers; a reduced rehearsal's depth rounds up to 4
    pipe_cfg = cfg.replace(n_layers=-(-cfg.n_layers // 4) * 4)
    p0 = T.init_params(pipe_cfg, 0, device=dev)
    with torch.no_grad():
        x = T._embed(cfg, p0, tokens)
        x_micro = x.reshape(PIPE_MICRO, -1, *x.shape[1:])
        pos = torch.arange(x.shape[1], device=dev)[None].expand(
            x_micro.shape[1], -1)
        pipe_ref = torch.empty_like(x_micro)
        for j in range(PIPE_MICRO):
            h = x_micro[j]
            for i, lp in enumerate(p0["layers"]):
                h, _ = T._block(pipe_cfg, lp, T._Named(FpCtx(), f"layer{i}/"), h,
                                lambda p, c, x_: A.attention(cfg, p, c, x_,
                                                             pos))
            pipe_ref[j] = h
    del p0
    gen = torch.Generator(device=dev).manual_seed(19)
    mm_x = torch.randn(32, cfg.d_model, device=dev, generator=gen)
    mm_w = torch.randn(cfg.d_model, cfg.d_ff, device=dev, generator=gen)
    mm_w /= math.sqrt(cfg.d_model)
    hier_x = torch.arange(2 * 2 * 3 * 6 * 5, dtype=torch.float32,
                          device=dev).reshape(2, 2, 3, 6, 5)
    job = {"cfg": cfg, "batches": batches, "acfg": acfg,
           "ref_params": params, "pipe_cfg": pipe_cfg, "pipe_x": x_micro,
           "pipe_ref": pipe_ref,
           "mm_x": mm_x, "mm_w": mm_w, "hier_x": hier_x,
           "ckpt_dir": str(scratch / "ckpt")}
    worlds = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        outs = run_ranks(dist_rank, world, (world, str(ROOT / "src"),
                                            str(dev), job),
                         backend="gloo", timeout_s=TP_TIMEOUT_S)
        worlds[world] = (outs, time.perf_counter() - t0)
    del job, params, x_micro, pipe_ref
    shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()

    # (a) the sharded steps against the single-device steps
    for world, (outs, wall) in worlds.items():
        mesh_s = "(2, 1)" if world == 2 else "(2, 2)"
        for rank, o in enumerate(outs):
            for k_, (got, want) in enumerate(zip(o["metrics"], single)):
                for key in ("loss", "grad_norm"):
                    if abs(got[key] - want[key]) > DIST_RTOL * abs(want[key]):
                        raise AssertionError(
                            f"sharded step {k_ + 1} at {mesh_s}, rank {rank}:"
                            f" {key} {got[key]} against the single-device "
                            f"{want[key]}")
            if o["param_gap"] > DIST_PARAM_ATOL:
                raise AssertionError(f"sharded steps at {mesh_s}, rank {rank}:"
                                     f" params {o['param_gap']} off")
        med = _median([s_ for o in outs for s_ in o["step_s"][1:]])
        gaps = [o["param_gap"] for o in outs]
        loss_gap = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                       for o in outs for g, w in zip(o["metrics"], single))
        norm_gap = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                       for o in outs for g, w in zip(o["metrics"], single))
        rep[f"mesh {mesh_s}"] = {
            "wall_s": wall, "step_s": [o["step_s"] for o in outs],
            "median_step_s": med, "param_gap": gaps,
            "loss_rel_gap": loss_gap, "grad_norm_rel_gap": norm_gap,
            "local_bytes": [o["local_bytes"] for o in outs],
            "global_bytes": outs[0]["global_bytes"],
            "peak_gib": [o["peak_gib"] for o in outs]}
        print(f"dist gpt2-small sharded step at mesh {mesh_s} ({world} gloo "
              f"ranks, one card): 3 steps, loss "
              f"{[round(g['loss'], 5) for g in outs[0]['metrics']]}, largest "
              f"gaps from the single-device step: loss {loss_gap:.2e} rel, "
              f"grad_norm {norm_gap:.2e} rel, params {max(gaps):.2e} abs "
              f"(gates {DIST_RTOL:g} / {DIST_PARAM_ATOL:g}); median step "
              f"{med * 1e3:.1f} ms (host clock, gloo transport; the "
              f"single-device step {_median(single_s[1:]) * 1e3:.1f}"
              f" ms); params + mu + nu a rank "
              f"{[round(o['local_bytes'] / 2**20, 1) for o in outs]} MiB of "
              f"{outs[0]['global_bytes'] / 2**20:.1f} MiB; peak "
              f"{[o['peak_gib'] and round(o['peak_gib'], 2) for o in outs]} GiB; world "
              f"{wall:.1f} s  [{card}]", flush=True)
    rep["single_step_s"] = single_s

    # (b) the compressed all-reduce at dp 2
    ef = [o["ef"] for o in worlds[2][0]]
    for rank, e in enumerate(ef):
        if not e["one_shot_rel"] < EF_SHOT_RTOL:
            raise AssertionError(f"int8 EF sum, rank {rank}: one-shot relative "
                                 f"error {e['one_shot_rel']}")
        if not e["residual_over_g"] < 1.0:
            raise AssertionError(f"int8 EF sum, rank {rank}: residual "
                                 f"{e['residual_over_g']} x |g| over 20 "
                                 "repeats")
    rep["ef"] = ef
    print(f"dist int8 error-feedback sum of one step's gradients at dp 2 "
          f"({ef[0]['leaves']} leaves): one-shot relative error by rank "
          f"{[round(e['one_shot_rel'], 5) for e in ef]} (gate "
          f"{EF_SHOT_RTOL}); the residual over 20 repeats at most "
          f"{[round(e['residual_over_g'], 5) for e in ef]} x max |g| (gate "
          f"1)  [{card}]", flush=True)

    # (c)-(e) at 4 ranks
    outs = worlds[4][0]
    for rank, o in enumerate(outs):
        if o["pipe_gap"] > PIPE_RTOL * o["pipe_scale"]:
            raise AssertionError(f"pipeline, stage {rank}: {o['pipe_gap']} "
                                 "off the unpipelined stack")
        if o["mm_gap"] > MATMUL_RTOL * o["mm_scale"]:
            raise AssertionError(f"ring matmul, rank {rank}: {o['mm_gap']} "
                                 "off one matmul")
        if not o["hier_equal"]:
            raise AssertionError(f"hierarchical sum, rank {rank}: not exact")
        if not o["ckpt_equal"]:
            raise AssertionError(f"checkpoint, rank {rank}: a restored shard "
                                 "differs from the saved tree")
    rep["world4"] = [{k: o[k] for k in (
        "pipe_gap", "pipe_scale", "pipe_s", "pipe_host_copies", "mm_gap",
        "mm_scale", "mm_host_copies", "hier_equal", "ckpt_equal",
        "ckpt_save_s")} for o in outs]
    print(f"dist GPipe, gpt2-small's 12 blocks in 4 stages of 3, "
          f"{PIPE_MICRO} micro-batches of {TRAIN_BATCH // PIPE_MICRO} x "
          f"{TRAIN_SEQ}: max abs gap from the unpipelined stack "
          f"{max(o['pipe_gap'] for o in outs):.2e} (scale "
          f"{outs[0]['pipe_scale']:.2f}, gate {PIPE_RTOL:g} of it), "
          f"{max(o['pipe_s'] for o in outs):.3f} s; host copies by stage "
          f"{[o['pipe_host_copies'] for o in outs]}; ring matmul [32, "
          f"{cfg.d_model}] x [{cfg.d_model}, {cfg.d_ff}] / 4: max gap "
          f"{max(o['mm_gap'] for o in outs):.2e} (scale "
          f"{outs[0]['mm_scale']:.2f}, gate {MATMUL_RTOL:g} of it), host "
          f"copies by rank {[o['mm_host_copies'] for o in outs]}; "
          f"hierarchical sum on (pod 2, data 2) "
          f"exact; checkpoint saved at (2, 2) in "
          f"{outs[0]['ckpt_save_s']:.1f} s and restored bit-equal at (4, 1) "
          f"and (1, 4)  [{card}]", flush=True)
    rep["host_copies_routed"] = sorted(C.HOST_ROUTED["gloo"])
    return rep

def dryrun_phase(torch, dev, card, cell_cfg, reset_counts, read_counts):
    """Phase 20: the dry-run's sweep (a) and tensor-parallel cells (b) in
    spawned workers, then (c) one cell's per-rank program (``cell_cfg``
    at DRYRUN_CELL's shape) on the card against its meta trace.  Returns
    (the phase's report, {label: launch counts} of (c)'s counted step)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from repro_torch.analysis import roofline as R
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP

    rep = {}
    # (a) + (b): the longest cells (train) first
    cells = ([(a, "train_4k", True) for a in DRYRUN_MULTIPOD]
             + [(a, s_, False) for s_ in SP.SHAPES for a in ARCHS])
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(DRYRUN_WORKERS,
                                mp_context=mp.get_context("spawn")) as pool:
        tp_futs = [pool.submit(D.lower_paged_cell, a, DRYRUN_TP,
                               kv_mode="int8") for a in DRYRUN_TP_ARCHS]
        futs = [pool.submit(D.run_cell, a, s_, multi_pod=mp_,
                            quant=D.resolve_quant("auto", s_), save=True)
                for a, s_, mp_ in cells]
        recs = [f.result() for f in futs]
        tps = [f.result() for f in tp_futs]
    sweep_s = time.perf_counter() - t0
    bad, n_skip = [], 0
    for rec in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        print(f"{D.summary(rec)} [{card}]", flush=True)
        c = get_config(rec["arch"])
        if rec["status"] == "skipped":
            n_skip += 1
            want = SP.cell_supported(c, SP.SHAPES[rec["shape"]])
            if (rec["shape"] != "long_500k" or c.family in ("ssm", "hybrid")
                    or want != (False, rec["reason"])):
                bad.append(rec)
        elif rec["status"] != "ok":
            bad.append(rec)
    if bad or n_skip != 9:
        raise AssertionError(
            f"dry-run sweep: {n_skip} cells skipped (9 expected); bad cells "
            + "; ".join(f"{r['arch']} {r['shape']} {r['mesh']}: "
                        f"{r.get('error', r.get('reason'))}" for r in bad))
    big = sorted((r for r in recs if r["status"] == "ok"),
                 key=lambda r: -r["memory"]["peak_size_in_bytes"])[:5]
    print(f"dry-run sweep: {len(recs)} cells ({len(recs) - n_skip} ok, "
          f"{n_skip} skipped for the reference's reason) in {sweep_s:.1f} s "
          f"on {DRYRUN_WORKERS} workers; largest per-rank peaks "
          + ", ".join(f"{r['arch']} {r['shape']} {r['mesh']} "
                      f"{r['memory']['peak_size_in_bytes'] / 2**30:.1f} GiB"
                      for r in big) + "  (roofline arithmetic on H100 "
          f"constants, not a measurement) [{card}]", flush=True)
    for cell in tps:
        if not (cell["lowered"] and cell["heads_sharded"]
                and cell["kv_shards"] == DRYRUN_TP
                and cell["cache_bytes_per_shard"]
                == cell["cache_bytes"] // DRYRUN_TP):
            raise AssertionError(f"tensor-parallel dry-run: {cell}")
        print(f"tensor-parallel dry-run {cell['arch']} tp {cell['tp']} "
              f"[{cell['kv_mode']}]: {cell['kv_shards']} KV shards, "
              f"{cell['cache_bytes_per_shard']} of {cell['cache_bytes']} pool "
              "bytes a shard; one pooled decode of a rank traced on meta "
              "tensors", flush=True)
    rep.update(sweep_s=sweep_s, cells=recs, tensor_parallel=tps)

    # (c) one cell's per-rank program on the card ----------------------------
    arch, shape_name = DRYRUN_CELL
    cfg = cell_cfg.replace(dtype="bfloat16", remat=True)
    shape = SP.SHAPES[shape_name]
    plan = {"data": 16, "model": 16}
    sweep_rec = next(r for r in recs if (r["arch"], r["shape"], r["mesh"])
                     == (arch, shape_name, "16x16"))
    D._set_sharding(cfg, shape, plan, False)
    try:
        mstep, margs, mheld, tokens = D.serve_program(cfg, shape, plan,
                                                      "muxq", device="meta")
        meta = D.trace(mstep, margs, mheld)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        step, args, held, _ = D.serve_program(cfg, shape, plan, "muxq",
                                              device=dev)

        def layout(bufs):
            return {s_: {f: (tuple(t.shape), t.stride(), t.dtype)
                         for f, t in b_.items()} for s_, b_ in bufs.items()}
        if layout(held) != layout(mheld):
            raise AssertionError("(c) the buffers packed on the card differ "
                                 "in shape from the meta program's")
        del mstep, margs, mheld
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        on_card = D.trace(step, args, held)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_card = torch.cuda.max_memory_allocated() - base
        for name in ("rowwise_quantize", "muxq_gemm"):
            got, want = on_card["kernels"][name], meta["kernels"][name]
            if got != want or counts[name] != want["calls"]:
                raise AssertionError(
                    f"(c) {name}: card {got}, {counts[name]} launches; meta "
                    f"trace {want}")
            # (the emulator's rehearsal runs (c) at a reduced size)
            if cell_cfg == get_config(arch) and sweep_rec["kernels"][name] \
                    != want:
                raise AssertionError(f"(c) {name}: the sweep's cell counted "
                                     f"{sweep_rec['kernels'][name]}, the "
                                     f"meta trace here {want}")
        same_total = on_card["cost"] == meta["cost"]
        with torch.no_grad():
            prev = dispatch.set_fused_impl("ref")
            try:
                plain_tok, _ = step(*args)
            finally:
                dispatch.set_fused_impl(prev)
            kern_tok, _ = step(*args)
        torch.cuda.synchronize()
        if not torch.equal(plain_tok, kern_tok):
            raise AssertionError("(c) next tokens through the kernels differ "
                                 "from those through the plain versions")
        times = event_times(torch, lambda: step(*args), DRYRUN_STEPS)
        # where a step's time goes: 3 more steps under the profiler, their
        # kernel time against the median unprofiled step
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(*args)
            torch.cuda.synchronize()
    finally:
        D._reset_sharding()
    # kernel rows only: an aten op's row also carries its kernels' time
    rows = [(e.key, e.self_device_time_total / 3e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(t for _, t in rows)
    top = [(_kernel_label(k), t) for k, t in sorted(
        (r for r in rows if r[1] > 0), key=lambda r: -r[1])[:5]]
    cost = meta["cost"]
    roof = R.make_roofline(cost, meta["coll"], cfg, tokens, shape.mode, 256,
                           int8_fraction=cost["int8 ops"] / cost["flops"])
    step_ms = _median(times)
    out = {"arch": arch, "shape": shape_name, "rows": int(args[1]["tokens"]
                                                          .shape[0]),
           "cost": cost, "card_cost": on_card["cost"],
           "same_total_counts": same_total, "kernels": meta["kernels"],
           "launches": {k: v for k, v in counts.items() if v},
           "step_ms": step_ms, "step_ms_spread": (min(times), max(times)),
           "roofline": roof.as_dict(), "ratio": step_ms / 1e3 / roof.step_s,
           "device_ms_per_step": dev_ms,
           "busy_share": dev_ms / step_ms if step_ms else None,
           "top_kernels_ms": top,
           "trace_peak_bytes": meta["mem"]["peak_size_in_bytes"],
           "card_counter_peak_bytes": on_card["mem"]["peak_size_in_bytes"],
           "max_memory_allocated": peak_card,
           "argument_bytes": meta["mem"]["argument_size_in_bytes"]}
    rep["cell"] = out
    print(f"dry-run cell on the card, {arch} {shape_name} (a rank's "
          f"{out['rows']} rows, {shape.seq_len}-position bf16 cache, fused "
          f"MUXQ): counted flops {cost['flops']:.6g}, bytes "
          f"{cost['bytes accessed']:.6g} (card's count equal: {same_total}); "
          f"rowwise_quantize / muxq_gemm calls, ops and bytes equal to the "
          f"meta trace's, launches {counts['rowwise_quantize']} / "
          f"{counts['muxq_gemm']}; tokens through the kernels equal the "
          f"plain versions'; step {step_ms:.4f} ms (median of "
          f"{DRYRUN_STEPS}, spread {min(times):.4f}-{max(times):.4f}) against "
          f"a roofline step of {roof.step_s * 1e3:.4f} ms "
          f"({roof.dominant}-bound; {out['ratio']:.2f}x); kernels "
          f"{dev_ms:.4f} ms a step (profiled), the card busy "
          f"{(out['busy_share'] or 0) * 100:.1f} % of the step; top kernels "
          + ", ".join(f"{k} {t:.3f} ms" for k, t in top)
          + f"; peak device memory {peak_card / 2**30:.3f} GiB against the "
          f"trace's {out['trace_peak_bytes'] / 2**30:.3f} GiB  [{card}]",
          flush=True)
    del step, args, held
    torch.cuda.empty_cache()
    return rep, {f"dry-run {arch} {shape_name}": counts}


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

    def paged_timing(mode, sq, heads, kvh, pos_list, label, plan_kvh=None):
        """The paged kernel at a serving shape: one slot per entry of
        ``pos_list`` (its position), with 128-position tables; bound from
        the pages these positions read and the (query, key) pairs the
        causal mask allows.  ``plan_kvh``: the KV heads the kernel's split
        plan is made for (a tensor-parallel rank's: the model's)."""
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
        return {"fn": lambda: PA.paged_attention_decode(
                    *args, **kw, plan_kv_heads=plan_kvh),
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

    def wide_paged_timing(arch, mode, sq, pos_list, label, tp=1):
        """The paged kernel at a wide shape, beside its plain version and
        SDPA on the gathered, dequantized K/V (none where a softcap makes
        SDPA another function); bound from the pages the rows' windows
        read and the (query, key) pairs they allow.  ``tp`` > 1: rank 0's
        heads of a tp-way serve (its pages, scales and redistribution rows
        contiguous), the split plan made for all of the model's heads."""
        c = wide[arch]
        dh_, kvh_, heads_ = c.head_dim, c.n_kv_heads, c.n_heads
        args, kw = wide_paged_case(c, mode, sq, pos_list, 7 + sq)
        if tp > 1:
            kvh_, heads_ = kvh_ // tp, heads_ // tp
            q, kp, vp, table, pos = args
            args = (q[:, :, :heads_].contiguous(), kp[:, :, :kvh_].contiguous(),
                    vp[:, :, :kvh_].contiguous(), table, pos)
            kw = {n_: (t_[:kvh_] if n_.endswith("redist") else t_[:, :, :kvh_]
                       ).contiguous() if torch.is_tensor(t_) else t_
                  for n_, t_ in kw.items()}
        q, kp, vp, table, pos = args
        w = kw.get("window", 1 << 30)
        pairs = sum(min(p + i + 1, w) for p in pos_list for i in range(sq))
        n_read = sum((p + sq - 1) // ps - max(0, p - w + 1) // ps + 1
                     for p in pos_list)
        nbytes = (n_read * ps * kvh_ * page_cost[mode](kp.element_size())
                  + 2 * q.numel() * 4 + table.numel() * 4 + 16
                  + (2 * kvh_ * dh_ * 4 if mode == "int4" else 0))
        row = {"kernel": f"paged_attention[{mode}]", "model": arch, "tp": tp,
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
        fn = lambda: PA.paged_attention_decode(*args, **kw,
                                               plan_kv_heads=c.n_kv_heads)
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
        return row

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
                       "prefix_hits": rep["prefix_hits"],
                       "cache_bytes": rep["cache_bytes"],
                       "outlier_runs": runs,
                       "streams": [r.out_tokens for r in greqs]}

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
                # the raw tree: the artifact's stubs its fused sites' weights
                out, _ = T.prefill_chunk_paged(cfg, params, toks, pool.kv,
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
    del engine, tengine, cal_pool   # the artifact is served again in phase 16
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
        against itself with every attention output nudged one ulp.
        ``params_`` is the raw tree: an artifact's stubs its fused sites'
        weights, which the fp gates read."""
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
    gates14 = in_situ(q14, p14, e14.ctx, "int8", None, "qwen2.5-14b")
    # (c) the head is lm_head: the same model read with a tied head differs
    untied = step_logits(q14, p14, FpCtx(), "int8")[0]
    tied = step_logits(q14.replace(tie_embeddings=True), p14, FpCtx(),
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
    gates9 = in_situ(g9, p9, e9.ctx, "int4", c9, "gemma2-9b",
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
    del p9, c9, e9                  # a9 (as served) is served again in phase 16
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
        gates = in_situ(c, params_, eng.ctx, mode,
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

    # -- 16. tensor-parallel serving: gloo ranks sharing the one card -----------
    # Every rank is a spawned process on this card (NCCL refuses two ranks on
    # one device) holding the whole replicated weights, its kvh / tp KV heads
    # and V_pad / tp head columns; the artifacts built above travel to the
    # ranks once (CUDA tensors by IPC), nothing is calibrated again.  The
    # streams must equal the single-device serves' and every rank rank 0's.
    def tp_world(tp, jobs):
        t0 = time.perf_counter()
        outs = run_ranks(tp_rank, tp, (tp, str(ROOT / "src"), str(dev), jobs),
                         backend="gloo", timeout_s=TP_TIMEOUT_S)
        return outs, time.perf_counter() - t0

    def tp_gate(outs, tp, idx, want, want_rep, sharded, n_layers):
        """The checks of job ``idx`` on every rank; its launches join the
        main path's counts, one entry a rank."""
        rows = [o[idx] for o in outs]
        label = rows[0]["label"]
        shards = tp if sharded else 1
        for rank, res in enumerate(rows):
            r_ = res["report"]
            where = f"{label} tp {tp} rank {rank}"
            if res["streams"] != want:
                raise AssertionError(f"{where}: the stream differs from the "
                                     "tp = 1 serve's")
            for k_, v_ in want_rep.items():
                if r_[k_] != v_:
                    raise AssertionError(f"{where}: {k_} {r_[k_]} != {v_} at "
                                         "tp = 1")
            if res["heads_sharded"] != sharded or r_["kv_shards"] != shards:
                raise AssertionError(f"{where}: {r_['kv_shards']} KV shards, "
                                     f"expected {shards}")
            if res["per_shard"] * shards != res["cache_bytes"]:
                raise AssertionError(f"{where}: {res['per_shard']} bytes a "
                                     f"shard of {res['cache_bytes']}")
            if any(n_ != n_layers for n_ in res["paged_per_step"]):
                raise AssertionError(f"{where}: paged launches per step "
                                     f"{res['paged_per_step']}, expected "
                                     f"{n_layers} (one a layer)")
            for key in ("rowwise_quantize", "muxq_gemm"):
                if res["counts"][key] <= 0:
                    raise AssertionError(f"{where} never launched {key}")
            main_runs[f"{label} tp {tp} rank {rank}"] = res["counts"]
        r0 = rows[0]
        print(f"serve {label} at tp {tp} (gloo ranks on one card): every "
              f"rank's stream equals the tp = 1 stream; {shards} KV "
              f"shard(s), {r0['per_shard']} of {r0['cache_bytes']} pool "
              f"bytes a rank; {len(r0['paged_per_step'])} steps, "
              f"{n_layers} paged launch(es) each; serve seconds by rank "
              f"{[round(x['seconds'], 3) for x in rows]}; peak device memory "
              f"by rank {[x['peak_gib'] for x in rows]} GiB; launches rank 0 "
              f"{r0['counts']}  [{card}]", flush=True)
        return [{k_: v_ for k_, v_ in x.items() if k_ != "streams"}
                for x in rows]

    def head_split(head, d_, label):
        """The vocabulary split on this card's GEMMs: a rank's
        x @ W[:, cols] against the same columns of x @ W."""
        out = {}
        for m in (4, 128):
            x = torch.randn(m, d_, generator=gen).to(dev)
            full = x @ head
            scale = float(full.abs().max())
            for tp in (2, 4):
                vl = head.shape[1] // tp
                errs = [float((x @ head.narrow(1, r * vl, vl)
                               - full[:, r * vl:(r + 1) * vl]).abs().max())
                        for r in range(tp)]
                out[f"m{m}_tp{tp}"] = max(errs)
                if max(errs) > LOGIT_RTOL * scale:
                    raise AssertionError(f"{label} head split at M {m}, tp "
                                         f"{tp}: {max(errs)} off the full "
                                         f"matmul (scale {scale})")
        print(f"head split {label} [{d_}, {head.shape[1]}]: max abs gap of a "
              f"rank's columns from the full matmul {out} (0 = bit-equal)  "
              f"[{card}]", flush=True)
        return out

    from repro_torch.parallel.ranks import run_ranks
    g9_kw = dict(max_batch=4, s_max=256, prefill_chunk=32, kv_mode="int4",
                 spec_mode="ngram", spec_k=4)
    gpt2_kw = dict(max_batch=4, s_max=256, prefill_chunk=32, kv_mode="int8")
    q2_kw = dict(max_batch=4, s_max=256, prefill_chunk=32, kv_mode="int4",
                 spec_mode="ngram", spec_k=4)
    jobs_of = {
        2: [("gpt2-small int8", cfg, art, gpt2_kw, prompts, 16),
            ("gemma2-9b int4 spec", g9, a9, g9_kw, qprompts, 16)],
        4: [("gpt2-small int8", cfg, art, gpt2_kw, prompts, 16),
            ("qwen2-0.5b int4 spec", qcfg, qart, q2_kw, qprompts, 16)]}
    tp_rep = {"worlds": {}}
    spec_keys = ("decode_steps", "prefill_steps", "spec_verify_steps",
                 "spec_proposed", "spec_accepted", "prefix_hits", "cow_copies",
                 "tokens_out", "cache_bytes")
    for tp in (2, 4):
        outs, wall = tp_world(tp, jobs_of[tp])
        tp_rep["worlds"][tp] = {"wall_s": wall, "jobs": {}}
        w_ = tp_rep["worlds"][tp]["jobs"]
        w_["gpt2-small int8"] = tp_gate(
            outs, tp, 0, report["serve"]["streams"],
            {k_: report["serve"][k_] for k_ in (
                "tokens_out", "decode_steps", "prefill_steps", "prefix_hits",
                "cache_bytes")}, True, cfg.n_layers)
        if tp == 2:
            w_["gemma2-9b int4 spec"] = tp_gate(
                outs, tp, 1, report["serve_gemma2_9b"]["streams"],
                {k_: report["serve_gemma2_9b"]["report"][k_]
                 for k_ in spec_keys}, True, g9.n_layers)
        else:
            w_["qwen2-0.5b int4 spec"] = tp_gate(
                outs, tp, 1, [r.out_tokens for r in qreqs],
                {k_: qrep[k_] for k_ in spec_keys}, False, qcfg.n_layers)
        cost = [o[-1]["allreduce_ms"] for o in outs]
        tp_rep["worlds"][tp]["allreduce_ms"] = cost
        print(f"tp {tp} world: {wall:.1f} s from spawn to the last rank's "
              f"exit; one gloo all_reduce of a CUDA tensor (16 KB, 1 MB, "
              f"16 MB), ms by rank: "
              f"{[[round(c[n_], 3) for n_ in sorted(c)] for c in cost]}  "
              f"[{card}]", flush=True)
    tp_rep["head_split"] = {   # both heads tied: the embedding's transpose
        "gpt2": head_split(art.params["embed"].T, cfg.d_model, "gpt2-small"),
        "gemma2": head_split(a9.params["embed"].T, g9.d_model, "gemma2-9b")}
    # the paged kernel at a rank's shapes, cold, planned for the model's heads
    gpt2_rank = paged_timing("int8", 1, h // 2, h // 2, [127, 100, 64, 40],
                             "gpt2 decode, rank of tp 2", plan_kvh=h)
    fn_ = gpt2_rank.pop("fn")
    gpt2_rank["ms"], gpt2_rank["spread_ms"] = time_ms(torch, fn_, flush)
    gpt2_rank.update(kernel="paged_attention[int8]", model="gpt2-small", tp=2)
    report["timings"].append(gpt2_rank)
    print(f"time paged_attention[int8] [{gpt2_rank['shape']}]: kernel "
          f"{gpt2_rank['ms']:.4f} ms (spread {gpt2_rank['spread_ms'][0]:.4f}-"
          f"{gpt2_rank['spread_ms'][1]:.4f}), plain "
          f"{gpt2_rank['plain_ms']:.4f} ms, SDPA {gpt2_rank['library_ms']:.4f}"
          f" ms, bound {gpt2_rank['bound_ms']:.6f} ms "
          f"({gpt2_rank['bound_by']}); all 12 heads "
          f"{timed['paged_attention[int8]']['ms']:.4f} ms  [{card}]",
          flush=True)
    g9_rank = wide_paged_timing("gemma2-9b", "int4", 1,
                                [p_ - g9w for p_ in span],
                                "gemma2-9b decode inside the window, rank of "
                                "tp 2", tp=2)
    tp_rep["paged_rank_timings"] = [gpt2_rank, g9_rank]
    report["tensor_parallel"] = tp_rep
    del art, a9
    torch.cuda.empty_cache()
    phases.done("tensor-parallel serving")

    # -- 17. training and the paper's pipeline on trained weights ---------------
    report["training"], train_runs = train_phase(
        torch, dev, cfg, card, reset_counts, read_counts, flush,
        ROOT / "build" / "chip_smoke_train")
    main_runs.update(train_runs)
    torch.cuda.empty_cache()
    phases.done("training")

    # -- 18. the SSM, hybrid and encoder-decoder families -----------------------
    fam = {a: get_config(a) for a in FAMILY_ARCHS}
    report["families"], fam_runs = families_phase(
        torch, dev, fam, card, reset_counts, read_counts, flush, record,
        report["timings"], phases)
    main_runs.update(fam_runs)

    # -- 19. distributed training -----------------------------------------------
    report["distributed"] = dist_phase(torch, dev, cfg, card,
                                       ROOT / "build" / "chip_smoke_dist")
    phases.done("distributed training")

    # -- 20. analysis and the dry-run -------------------------------------------
    report["dryrun"], dry_runs = dryrun_phase(torch, dev, card, qcfg,
                                              reset_counts, read_counts)
    main_runs.update(dry_runs)
    phases.done("analysis and dry-run")

    # -- 21. result lines ---------------------------------------------------------
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
