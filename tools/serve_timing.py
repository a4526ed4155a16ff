#!/usr/bin/env python3
"""Host-clock time of the gpt2-small int8 serve of ``chip_smoke.py``
(phase 4), for the current tree beside an earlier commit's.

    python3 tools/serve_timing.py compare DIR [--repeats N] [--rounds R]
    python3 tools/serve_timing.py serve [--repeats N]

``serve`` builds the artifact of ``chip_smoke.py``'s phase 4 (gpt2-small
at full width, random weights from seed 0 with 8 LayerNorm gain channels
x20, calibrated on two 2 x 64-token batches, uniform fused MUXQ) and serves
its 4 requests x 16 tokens on int8 pages: once untimed (it builds and
loads the kernels, as ``chip_smoke.py``'s earlier phases do before its
serve), then ``--repeats`` times, each on a fresh ``ServeEngine`` so that
every run does the same work (no prefix hits).  It times
``engine.generate`` alone, synchronized, and imports ``repro_torch`` from
``PYTHONPATH``.

``compare DIR`` runs ``serve`` in child processes in turns, earlier,
current, current, earlier, ``--rounds`` times: ``DIR`` is a checkout of an
earlier commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists (its kernels build into ``DIR/build``).  It prints
the median and range of each process's serves and, per tree, the median
of all its serves, beside the card's name and power limit, and writes
everything to ``chiprun_out/serve_timing.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROMPTS = ["The quantized model serves every request through paged "
           "attention on the card.",
           "Outlier channels are shifted down by a power of two.",
           "one int8 GEMM",
           "Chunked prefill interleaves with the pooled decode so that "
           "long prompts never stall the live slots of the pool."]


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def serve(repeats: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.context import CollectCtx
    from repro_torch.core.muxq import QuantConfig
    from repro_torch.core.policy import SitePolicy
    from repro_torch.models import transformer as T
    from repro_torch.quantize import build_artifact
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.pool import PagePool

    if not torch.cuda.is_available():
        raise SystemExit("serve_timing: no CUDA device")
    dev = torch.device("cuda")
    cfg = get_config("gpt2-small")
    params = T.init_params(cfg, seed=0, device=dev)
    hot = torch.randperm(cfg.d_model,
                         generator=torch.Generator().manual_seed(1))[:8].to(dev)
    for lp in params["layers"]:
        lp["ln1"]["gain"][hot] *= 20.0
        lp["ln2"]["gain"][hot] *= 20.0
    collect = CollectCtx()
    cal_pool = PagePool(cfg, 2, 64, page_size=16, mode="fp",
                        dtype=torch.float32, device=dev)
    table = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
    zero2 = torch.zeros(2, dtype=torch.int32, device=dev)
    full2 = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for seed in (0, 1):
            toks = torch.randint(0, cfg.vocab_size, (2, 64),
                                 generator=torch.Generator().manual_seed(seed),
                                 dtype=torch.int32).to(dev)
            T.prefill_chunk_paged(cfg, params, toks, cal_pool.kv, table,
                                  zero2, zero2, full2, collect)
    policy = SitePolicy.uniform(QuantConfig(
        method="muxq", outlier_mode="static", act_granularity="per_token",
        backend="fused", weight_granularity="per_channel"))
    art = build_artifact(cfg, params, policy, collect.stats.masks())

    secs, streams = [], None
    for _ in range(1 + repeats):        # the first run is the warm-up
        engine = ServeEngine(cfg, art, max_batch=4, s_max=256,
                             prefill_chunk=32, kv_mode="int8", device=dev)
        reqs = [Request(p, max_new_tokens=16) for p in PROMPTS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = [r.out_tokens for r in reqs]
        if streams is not None and got != streams:
            raise AssertionError("a repeat served other tokens than the first")
        streams = got
    rep = engine.metrics.report()
    return {"warmup_s": secs[0], "repeat_s": secs[1:],
            "tokens_out": rep["tokens_out"], "decode_steps": rep["decode_steps"],
            "prefill_steps": rep["prefill_steps"]}


def compare(earlier: Path, repeats: int, rounds: int) -> None:
    card = smi_line()
    runs = []
    order = (("earlier", earlier), ("current", ROOT), ("current", ROOT),
             ("earlier", earlier)) * rounds
    for label, tree in order:
        env = {**os.environ, "PYTHONPATH": str(tree / "src")}
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "serve",
             "--repeats", str(repeats)], env=env, capture_output=True,
            text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"serve_timing: the {label} serve failed")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        r["tree"] = label
        runs.append(r)
        rs = r["repeat_s"]
        print(f"{label}: {len(rs)} serves median {statistics.median(rs):.4f} s "
              f"(range {min(rs):.4f}-{max(rs):.4f}); {r['tokens_out']} "
              f"tokens, {r['decode_steps']} decode + {r['prefill_steps']} "
              f"prefill steps  [{card}]", flush=True)
    for label in ("earlier", "current"):
        rs = [t for r in runs if r["tree"] == label for t in r["repeat_s"]]
        print(f"{label}, all {len(rs)} serves: median "
              f"{statistics.median(rs):.4f} s (range {min(rs):.4f}-"
              f"{max(rs):.4f})  [{card}]", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serve_timing.json").write_text(
        json.dumps({"card": card, "runs": runs}, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("compare", "serve"))
    ap.add_argument("earlier", nargs="?", type=Path)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if args.mode == "serve":
        print(json.dumps(serve(args.repeats)))
    elif args.earlier is None:
        ap.error("compare needs the earlier checkout's directory")
    else:
        compare(args.earlier.resolve(), args.repeats, args.rounds)


if __name__ == "__main__":
    main()
