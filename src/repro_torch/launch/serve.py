"""Serving launcher: build a model with random weights, quantize it into a
MUXQ artifact (calibrate -> plan -> prequantize -> pack), serve a batch of
prompts through the continuous-batching engine and report serving metrics
(tokens/s, TTFT, page-pool occupancy and fragmentation).

    python -m repro_torch.launch.serve --backend fused --kv-mode int4

The flags are the reference launcher's (``repro.launch.serve``) plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
``--arch`` takes gpt2-small or any of ``configs.list_archs()`` at its
reduced size; the engine serves the dense and MoE decoders and refuses
the SSM, hybrid and encoder-decoder archs, as the reference's does (they
serve through ``launch/steps.py``).
``--json-out PATH`` dumps the final metrics report, the registry snapshot
and (with ``--obs``) the quality snapshot as JSON.  ``--trace-out PATH``
records the run's request/step lifecycle and writes a Chrome-trace /
Perfetto JSON; ``--obs`` turns on the quant-quality observers (per-site
activation stats on eager quantized matmuls, KV-page saturation and
outlier drift sampled from the pool between steps).

``--tp N`` (N > 1) serves tensor-parallel: the model is built and
quantized once in this process, then N ranks are spawned
(``parallel.ranks.run_ranks``), each serving the same requests with its
``kvh / N`` KV heads and ``V_pad / N`` LM-head columns.
``--dist-backend`` picks the collectives' transport: ``nccl`` (the
default on a CUDA device) serves rank r on ``cuda:r`` and needs N visible
cards; ``gloo`` (the default on ``--device cpu``) serves every rank on
``--device``, so several ranks can share one card.  Rank 0 alone prints
the summary and writes ``--json-out`` and ``--trace-out``; every rank's
streams must equal rank 0's."""
from __future__ import annotations

import argparse
import contextlib
import io
import json
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.core.muxq import QuantConfig
from repro_torch.core.policy import SitePolicy
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.obs.quality import QualityObserver
from repro_torch.obs.trace import TraceRecorder
from repro_torch.parallel.ranks import BACKENDS, run_ranks
from repro_torch.quantize import PACK_TARGETS, quantize_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--quant", default="muxq",
                    choices=["fp", "naive", "muxq", "llm_int8", "smoothquant"])
    ap.add_argument("--backend", default="fake", choices=["fake", "fused"],
                    help="execution backend for quantized sites: 'fused' "
                         "runs the packed single-GEMM MUXQ kernel path")
    ap.add_argument("--kv-mode", default="auto",
                    choices=["auto", "int8", "int4", "fp"],
                    help="page-pool mode: int8 pages + per-(pos, head) "
                         "scales, int4 MUXQ'd nibble-packed pages (half the "
                         "int8 bytes; calibrated outlier redistribution "
                         "from the artifact's kv_calib section), or fp "
                         "pages; auto (default) = int8 for quantized "
                         "serving, fp for --quant fp")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV-cache page")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="total pool pages (default: every slot can hold "
                         "s_max tokens)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="per-slot prompt-token budget: prompts prefill "
                         "into pool pages at most this many tokens per "
                         "step, interleaved with the pooled decode")
    ap.add_argument("--prefill-slots", type=int, default=2,
                    help="prefilling slots advanced per step: up to this "
                         "many slots run one chunk each, batched into one "
                         "prefill call of one row per advancing slot")
    ap.add_argument("--prefill-aging", type=float, default=1.0,
                    help="anti-starvation credit for the chunk picker: "
                         "remaining-token equivalents forgiven per step a "
                         "prompt has waited (0 = pure shortest-remaining-"
                         "first)")
    ap.add_argument("--spec-mode", default="off", choices=["off", "ngram"],
                    help="self-speculative decoding: 'ngram' drafts tokens "
                         "by prompt-lookup over each slot's own history and "
                         "verifies every slot's draft block in one batched "
                         "step; greedy acceptance keeps the streams "
                         "identical")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative block width: 1 committed token + up "
                         "to spec-k - 1 drafted tokens per verify step")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel serving group size: N ranks "
                         "shard the KV pages (and int8/int4 scales + int4 "
                         "redistribution rows) on the KV-head axis and the "
                         "LM head by vocabulary columns; 1 (default) serves "
                         "in this process with no group.  A model whose "
                         "kv-head count N doesn't divide falls back to "
                         "replicated placement (no capacity win, same "
                         "outputs)")
    ap.add_argument("--dist-backend", default=None, choices=list(BACKENDS),
                    help="transport of the --tp ranks' collectives: nccl "
                         "(default on a CUDA device; rank r serves on "
                         "cuda:r) or gloo (default on --device cpu; every "
                         "rank serves on --device, so ranks can share one "
                         "card)")
    ap.add_argument("--max-batch", type=int, default=2,
                    help="slot-pool size (concurrent sequences)")
    ap.add_argument("--s-max", type=int, default=128,
                    help="per-slot token capacity")
    ap.add_argument("--pack-target", default="both", choices=list(PACK_TARGETS),
                    help="which per-weight copy the artifact keeps for "
                         "fused sites: both | fused | tree")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--save-artifact", default=None,
                    help="directory to save the QuantArtifact bundle to")
    ap.add_argument("--prompts", nargs="*",
                    default=["the model computes", "a kernel shards"])
    ap.add_argument("--trace-out", default=None,
                    help="record request/step lifecycle spans and write a "
                         "Chrome-trace/Perfetto JSON here (load it in "
                         "ui.perfetto.dev); tracing is off (zero-cost) "
                         "when unset")
    ap.add_argument("--obs", action="store_true",
                    help="enable the quant-quality observers: per-site "
                         "activation amax/clip-rate on eager quantized "
                         "matmuls and KV-page saturation + outlier-mask "
                         "drift sampled from the pool between steps")
    ap.add_argument("--json-out", default=None,
                    help="dump the final metrics report plus the registry "
                         "snapshot (and the --obs quality snapshot) as "
                         "JSON to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.tp > 1 and backend == "nccl":
        if device.type != "cuda":
            raise SystemExit(
                f"--dist-backend nccl serves rank r on cuda:r, not on "
                f"--device {args.device}: use --dist-backend gloo")
        if args.tp > torch.cuda.device_count():
            raise SystemExit(
                f"--tp {args.tp}: nccl needs one CUDA device a rank, but "
                f"{torch.cuda.device_count()} device(s) are visible — lower "
                "--tp, or pass --dist-backend gloo to run every rank on "
                "--device")
    if args.quant != "fp" and args.backend == "fused":
        if args.quant == "llm_int8":
            raise SystemExit("llm_int8 has no fused kernel realization")
        if args.pack_target == "tree":
            raise SystemExit(
                "--pack-target tree drops the fused kernel buffers and "
                "rewrites fused routing to the fake backend — it cannot "
                "serve --backend fused (use 'both' or 'fused')")

    cfg = get_config(args.arch, reduced=True)
    params = T.init_params(cfg, seed=0, device=device)
    kv_mode = None if args.kv_mode == "auto" else args.kv_mode
    engine_kw = dict(max_batch=args.max_batch, s_max=args.s_max,
                     kv_mode=kv_mode, page_size=args.page_size,
                     n_pages=args.n_pages, prefill_chunk=args.prefill_chunk,
                     prefill_slots=args.prefill_slots,
                     prefill_aging=args.prefill_aging,
                     cache_dtype=torch.bfloat16,
                     spec_mode=args.spec_mode, spec_k=args.spec_k)
    if args.tp == 1:
        # activation seam: eager quantized matmuls report per-site stats
        # (the engine's step calls run with observation suspended)
        quality = QualityObserver() if args.obs else None
        prev_obs = dispatch.set_quality_observer(quality)
        try:
            served = _served(args, cfg, params, device)
            outs = [_serve_rank(0, args, cfg, served, engine_kw, device,
                                quality)]
        finally:
            dispatch.set_quality_observer(prev_obs)
    else:
        served = _served(args, cfg, params, device)
        outs = run_ranks(_serve_rank, args.tp,
                         (args, cfg, served, engine_kw,
                          None if backend == "nccl" else device, None),
                         backend=backend)
    print(outs[0]["summary"], end="")
    diverged = [r for r, o in enumerate(outs)
                if o["streams"] != outs[0]["streams"]]
    if diverged:
        raise SystemExit(f"--tp {args.tp}: the streams of rank(s) {diverged} "
                         "differ from rank 0's")
    return 0


def _served(args, cfg, params, device):
    """What the engine serves: the raw params under --quant fp, else the
    artifact quantized from them (built once, whatever --tp)."""
    if args.quant == "fp":
        return params
    spec = QuantConfig(method=args.quant, act_granularity="per_token",
                       outlier_mode="static")
    if args.backend == "fused":    # the packed kernel is per-channel
        spec = spec.replace(backend="fused",
                            weight_granularity="per_channel")
    policy = SitePolicy.uniform(spec)
    pipe = TokenPipeline(PipelineConfig(seq_len=64, global_batch=2))
    artifact = quantize_model(cfg, params, [next(pipe) for _ in range(2)],
                              policy, pack_target=args.pack_target,
                              device=device)
    if args.save_artifact:
        print(f"artifact saved to {artifact.save(args.save_artifact)}")
    return artifact


def _serve_rank(rank, args, cfg, served, engine_kw, device, quality):
    """Serve the prompts as rank ``rank`` of ``--tp`` (on ``cuda:rank``
    when ``device`` is None, the nccl layout) and report from rank 0.
    Returns {"streams", "summary"}: the summary is what rank 0's report
    printed, for the caller to print."""
    if args.tp > 1:
        device = device or torch.device("cuda", rank)
        quality = QualityObserver() if args.obs else None
    recorder = TraceRecorder() if args.trace_out else None
    engine = ServeEngine(cfg, served, **engine_kw, recorder=recorder,
                         quality=quality, device=device, tp=args.tp)
    reqs = [Request(p, max_new_tokens=args.max_new) for p in args.prompts]
    engine.generate(reqs)
    out = io.StringIO()
    if rank == 0:
        with contextlib.redirect_stdout(out):
            _report(args, engine, reqs, recorder, quality)
    return {"streams": [r.out_tokens for r in reqs], "summary": out.getvalue()}


def _report(args, engine, reqs, recorder, quality) -> None:
    """The summary lines, the trace file and the --json-out document."""
    for r in reqs:
        print(f"{r.prompt!r} -> {ServeEngine.text(r)!r} ({len(r.out_tokens)} tokens)")
    rep = engine.metrics.report()
    print(f"serve: {rep['tokens_per_sec']:.1f} tok/s over "
          f"{rep['decode_steps']} pooled decode steps "
          f"(batch mean {rep['decode_batch_mean']:.2f}); "
          f"prefill {rep['prefills']} prompts in {rep['prefill_chunks']} "
          f"chunks over {rep['prefill_steps']} batched steps "
          f"(chunk={args.prefill_chunk}, slots={args.prefill_slots}, "
          f"batch mean {rep['prefill_batch_mean']:.2f}, "
          f"{rep['prefill_multi_steps']} multi-slot steps, "
          f"{rep['prefill_resumes']} true resumes, "
          f"{rep['interleaved_steps']} interleaved steps, "
          f"{rep['decode_stall_steps']} stalls); "
          f"ttft mean {rep['ttft_ms_mean']:.0f} ms; "
          f"pool occupancy mean {rep['pool_occupancy_mean']:.2f} "
          f"peak {rep['pool_occupancy_peak']:.2f}; "
          f"fragmentation {rep['fragmentation_mean']:.2f}; "
          f"kv pages [{engine.pool.mode}] {rep['cache_bytes']} bytes; "
          f"decode read savings {rep['kv_read_savings']:.0%} "
          f"(block-sparse {rep['kv_bytes_read']} vs dense "
          f"{rep['kv_bytes_read_dense']} bytes); "
          f"prefix hits {rep['prefix_hits']} "
          f"(cow {rep['cow_copies']})"
          + (f"; spec[{args.spec_mode}] accepted {rep['spec_accepted']}/"
             f"{rep['spec_proposed']} drafts "
             f"({rep['spec_acceptance']:.0%}) over "
             f"{rep['spec_verify_steps']} verify steps, "
             f"{rep['decode_steps_saved']} slot-steps saved"
             if args.spec_mode != "off" else ""))
    if quality is not None:
        q = quality.snapshot()
        print(f"obs: {len(q['sites'])} quantized sites observed, "
              f"{q['pool_samples']} KV-pool samples")
        for name, s in sorted(q["sites"].items()):
            print(f"  {name}: amax {s['amax']:.3g} "
                  f"clip {s['clip_rate']:.2%} "
                  f"outlier-hit {s['outlier_hit_rate']:.0%}")
    if recorder is not None:
        path = recorder.export_chrome(args.trace_out)
        print(f"trace: {len(recorder.events)} events "
              f"({recorder.dropped} dropped) -> {path}")
    if args.json_out:
        reg = getattr(engine.metrics, "registry", None)
        doc = {"report": rep,
               "registry": reg.snapshot() if reg is not None else {},
               "quality": quality.snapshot() if quality is not None else {}}
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2, sort_keys=True))
        print(f"json: report + registry snapshot -> {out}")


if __name__ == "__main__":
    raise SystemExit(main())
