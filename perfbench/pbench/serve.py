"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result.

Set-up makes the weights (with the configuration's architecture,
``cells.arch``) and two calibration batches from the seed, quantizes
through the program's ``quantize_model`` (static MUXQ masks, packed
fused-site buffers, the f32 site weights dropped) and builds the
program's ``ServeEngine``.  The whole arrival schedule then goes to one
scheduler run: its first ``warmup_steps`` steps fill the slots (and, for
a documents mix, prefill every document), and the window opens at the
end of the step before.  It closes at the end of the first step that
ends ``seconds`` later; the harness stops the scheduler there by raising
from its step hook.  With ``trace`` the program's flight recorder runs
too and ``torch.profiler`` covers a stretch of the window.

Once the window has closed and the program is freed, the architecture's
reference runs over a sample of the finished requests, drawn from the
seed with the longest among them, and the widest gap of a served token's
reference logit below the reference's best, and the mean of those gaps,
are held against the cell's limits (``perfbench/limits/<cell>.json`` names the
numbers compared).  The control (``CONTROLS``) is the reference one step
down in precision, put in the program's place: its tokens are judged by
the same limits, and it has to come out not correct.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pbench import cells, reference, stamps, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STEPS_PER_S_CAP = 100     # the schedule covers a window run this fast
SAMPLE_TOKENS = 512       # served tokens the reference checks
REF_TOKENS = 24576        # and at most this many tokens it runs
PROFILE_S = 1.5           # the profiled stretch: at least this long
PROFILE_STEPS = 4         # and this many steps
PREFIX_S = (20.0, 30.0, 40.0)   # shorter windows logged from the same run

# the reference one step down in precision.  "w4" (int4 weights for the
# configuration's int8 sites) is the control; "bf16" (attention and LM
# head) and "tf32" are read for the record: the int8 activations turn any
# rounding upstream into the same floor, so they read as the program does
CONTROLS = {"w4": {"weight_bits": 4},
            "bf16": {"float_dtype": torch.bfloat16},
            "tf32": {"tf32": True}}


class WindowClosed(Exception):
    pass


def calib_batches(m: Dict, seed: int) -> List[np.ndarray]:
    """Two [2, 64] batches of token ids over the vocabulary."""
    rng = np.random.default_rng([int(seed), 2])
    return [rng.integers(0, m["vocab_size"], (2, 64)).astype(np.int32)
            for _ in range(2)]


def model_config(m: Dict):
    """The program's frozen ``ModelConfig``; a list-valued key (a per-layer
    pattern) becomes a tuple."""
    from repro_torch.models.common import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items()})


def setup_engine(m: Dict, mix: Dict, seed: int, device, recorder, arch):
    """Weights (``arch.tree``), calibration, packing and the engine."""
    from repro_torch.launch.steps import MUXQ_FUSED_SERVE
    from repro_torch.core.policy import SitePolicy
    from repro_torch.quantize import quantize_model
    from repro_torch.serve.engine import ServeEngine

    cfg = model_config(m)
    params = arch.tree(m, seed, device)
    art = quantize_model(cfg, params,
                         [{"tokens": b} for b in calib_batches(m, seed)],
                         SitePolicy.uniform(MUXQ_FUSED_SERVE),
                         pack_target="fused", device=device)
    del params
    s = mix["serving"]
    engine = ServeEngine(cfg, art, max_batch=s["max_batch"], s_max=s["s_max"],
                         kv_mode=s["kv_mode"], page_size=s["page_size"],
                         prefill_chunk=s["prefill_chunk"],
                         prefill_slots=s["prefill_slots"],
                         prefix_sharing=s["prefix_sharing"],
                         spec_mode="off", recorder=recorder, device=device)
    del art
    gc.collect()
    return engine


def _launches() -> int:
    from repro_torch.kernels import muxq_gemm, paged_attention, quantize
    return (muxq_gemm.LAUNCHES + quantize.LAUNCHES
            + sum(paged_attention.MODE_LAUNCHES.values()))


def counters(met) -> Dict[str, int]:
    """Every counter that ``ServeMetrics`` registers, by name, so a
    counter the program adds reaches a reader without an edit here.  Its
    gauges and histograms stay out: a window's difference of them means
    nothing, as it means only the rise for the counters that the program
    sets to a peak (``*_peak``, ``*_max``)."""
    from repro_torch.obs.registry import Counter
    return {n: c.value for n, c in met.registry._metrics.items()
            if isinstance(c, Counter)}


def p95(xs: List[float]) -> float:
    return statistics.quantiles(xs, n=20, method="inclusive")[-1] \
        if len(xs) > 1 else (xs[0] if xs else math.nan)


def window_metrics(st, t0: float, t1: float):
    """The end-to-end metrics of the window (t0, t1] from the stamps."""
    arrived = [rid for rid, a in st.arrive.items() if t0 <= a < t1]
    ttft = []
    for rid in arrived:
        toks = st.tokens.get(rid) or []
        first = toks[0] if toks and toks[0] <= t1 else t1
        ttft.append(1e3 * (first - st.arrive[rid]))
    itl, n_tok = [], 0
    for toks in st.tokens.values():
        inside = [t for t in toks if t0 < t <= t1]
        n_tok += len(inside)
        itl += [1e3 * (b - a) for a, b in zip(inside, inside[1:])]
    e2e = {"output_tokens_per_s": (n_tok / (t1 - t0), "tokens/s"),
           "ttft_p95_ms": (p95(ttft), "ms"),
           "itl_p95_ms": (p95(itl), "ms")}
    return e2e, arrived, ttft, itl, n_tok


def longest_step_ms(st, t0: float, t1: float) -> float:
    """The longest gap between two step ends in the window: where the
    host stood still."""
    walls = [t0] + [r["wall"] for r in st.steps if t0 < r["wall"] <= t1]
    return max((1e3 * (b - a) for a, b in zip(walls, walls[1:])),
               default=math.nan)


def judge(check: Dict, limits: Dict, failed: int, sampled: bool):
    """The numbers compared, each beside its limit, and the verdict."""
    numbers = {"max_logit_gap": check["gap"], "mean_logit_gap": check["mean"]}
    checks = {name: {"value": numbers[name], "limit": spec["limit"]}
              for name, spec in limits.items() if name in numbers}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    return checks, sampled and all(c["value"] <= c["limit"]
                                   for c in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = cells.ROOT, t_start=None,
             overrides: Optional[Dict] = None, controls=(),
             log=print) -> Dict:
    """One run; returns the result object (the contract's keys, with the
    comparison under ``checks``).  With ``controls`` (names in
    ``CONTROLS``) each is also put in the program's place and judged by
    the same limits; the result's ``correct`` is then theirs, true only
    where every one of them passes, and the program's own verdict is kept
    under ``program_correct``."""
    t_proc = t_start if t_start is not None else time.perf_counter()
    c = cells.cell(name, root)
    m, mix = c["config"]["port"], c["mix"]
    arch = cells.arch(c["config"], root / "perfbench")
    if overrides:
        m = {**m, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json")
                        .read_text())
    device = torch.device(device)
    inner = None
    if trace:
        from repro_torch.obs.trace import TraceRecorder
        inner = TraceRecorder(capacity=1 << 20)
    st = stamps.Stamps(inner)
    engine = setup_engine(m, mix, seed, device, st, arch)
    if trace and device.type == "cuda":
        from pbench.profile import warm_up
        warm_up(device)

    warm = int(mix["rehearsal"]["warmup_steps"])
    horizon = warm + int(math.ceil(
        seconds * (overrides or {}).get("steps_per_s", STEPS_PER_S_CAP)))
    items = traffic.generate(mix, seed, horizon)
    from repro_torch.serve.engine import Request
    reqs = [Request(it.prompt, max_new_tokens=it.max_new_tokens,
                    stream=st.stream(rid)) for rid, it in enumerate(items)]
    sched = engine.scheduler()
    state: Dict = {"open": None, "close": None, "span": None}

    def snapshot():
        return counters(sched.metrics), _launches()

    def on_step(rec):
        wall = rec["wall"]
        if state["open"] is None:
            if rec["step"] >= warm - 1:
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    # the peak of serving, not of set-up's f32 weights
                    torch.cuda.reset_peak_memory_stats(device)
                state["open"] = time.perf_counter()
                state["at_open"] = snapshot()
            return
        if trace and device.type == "cuda":
            span = state["span"]
            if span is None and wall >= state["open"] + 0.4 * seconds:
                from pbench.profile import Span
                state["span"] = span = Span()
                span.start(rec["step"])
            elif span is not None and span.t1 is None \
                    and wall >= span.t0 + PROFILE_S \
                    and rec["step"] >= span.first_step + PROFILE_STEPS:
                span.stop(rec["step"])
        if wall >= state["open"] + seconds:
            span = state["span"]
            if span is not None and span.t1 is None:
                span.stop(rec["step"])
            state["close"] = wall
            state["at_close"] = snapshot()
            raise WindowClosed

    st.on_step = on_step
    # the schedule's objects stay put: the collector's passes in the
    # window walk only what the run makes from here on
    gc.collect()
    gc.freeze()
    failed = 0
    try:
        sched.run(reqs, [it.arrive_step for it in items])
    except WindowClosed:
        pass
    if state["close"] is None:
        raise RuntimeError("the arrival schedule ran out before the window "
                           "closed")
    t0, t1 = state["open"], state["close"]
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

    # -- end-to-end metrics, from the stamps ---------------------------------
    e2e, arrived, ttft, itl, n_tok = window_metrics(st, t0, t1)
    e2e["setup_s"] = (t0 - t_proc, "s")
    prefix = {seconds: {k: v for k, (v, _) in e2e.items()}}
    for s_ in PREFIX_S:
        if s_ < seconds:
            ends = [r["wall"] for r in st.steps if r["wall"] >= t0 + s_]
            if ends:
                prefix[s_] = {k: v for k, (v, _) in
                              window_metrics(st, t0, ends[0])[0].items()}
    log(f"this window and shorter ones of this run: {json.dumps(prefix)}",
        file=sys.stderr)
    eos = sum(1 for r in reqs if r.done
              and len(r.out_tokens) < r.max_new_tokens)
    log(f"window {t1 - t0:.3f} s from step {warm}: {len(arrived)} requests "
        f"arrived, {n_tok} tokens; ttft n={len(ttft)} median="
        f"{statistics.median(ttft) if ttft else math.nan:.3f} ms; itl "
        f"n={len(itl)} median={statistics.median(itl) if itl else math.nan:.3f}"
        f" ms; longest step {longest_step_ms(st, t0, t1):.1f} ms; "
        f"{eos} requests stopped at EOS before their budget; "
        f"queue wait p95 {sched.metrics.percentile('queue_wait_steps', 0.95)}"
        f" steps", file=sys.stderr)

    records = None
    if trace:
        records = _records(st, inner, state, items, m, mix, device, t0, t1)

    finished = [rid for rid, r in enumerate(reqs)
                if r.done and st.tokens.get(rid) and t0 < st.tokens[rid][-1] <= t1]
    sample = _sample(finished, reqs, seed)
    seqs = [(items[rid].prompt, list(reqs[rid].out_tokens)) for rid in sample]
    del engine, sched, reqs
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------
    t_ref = time.perf_counter()
    check = compare(m, mix, seed, device, seqs, arch, controls=controls)
    check["seconds"] = time.perf_counter() - t_ref
    checks, correct = judge(check, limits, failed, bool(seqs))
    log(f"reference: {len(seqs)} requests, {check['tokens']} served tokens, "
        f"{check['differ']} differ from its argmax, mean gap "
        f"{check['mean']!r}, {check['seconds']:.1f} s",
        file=sys.stderr)
    verdicts = {}
    for k in controls:
        verdicts[k] = judge(check["controls"][k], limits, 0, bool(seqs))
        cc = check["controls"][k]
        log(f"control {k} in the program's place: correct "
            f"{verdicts[k][1]}; widest gap {cc['gap']!r}, mean "
            f"{cc['mean']!r}, {cc['differ']} of {cc['tokens']} tokens "
            f"differ", file=sys.stderr)

    metrics = {}
    if trace:
        for metric in c["per_layer"]:
            v = cells.reader(metric["name"], root / "perfbench")(records)
            if v is not None:
                metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
    else:
        for metric in c["end_to_end"]:
            v, unit = e2e[metric["name"]]
            metrics[metric["name"]] = {"value": v, "unit": unit}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": len(arrived), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and records.get("profile"):
        prof = records["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = prof["breakdown"]
    if controls:
        out["program_correct"] = correct
        out["correct"] = all(v[1] for v in verdicts.values())
        out["controls"] = {k: {**check["controls"][k], "correct": v[1],
                               "checks": v[0]}
                           for k, v in verdicts.items()}
    out["checks"] = checks
    return out


def _sample(finished: List[int], reqs, seed: int) -> List[int]:
    """The finished request with the most served tokens, then others drawn
    from the seed until SAMPLE_TOKENS served tokens, or until the next
    would take the reference past REF_TOKENS tokens."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: len(reqs[r].out_tokens))
    rest = [r for r in finished if r != longest]
    rng = np.random.default_rng([int(seed), 3])
    order = [rest[i] for i in rng.permutation(len(rest))]
    out, n = [longest], len(reqs[longest].out_tokens)
    cost = len(reqs[longest].prompt) + n
    for r in order:
        more = len(reqs[r].prompt) + len(reqs[r].out_tokens)
        if n >= SAMPLE_TOKENS or cost + more > REF_TOKENS:
            break
        out.append(r)
        n += len(reqs[r].out_tokens)
        cost += more
    return out


def compare(m: Dict, mix: Dict, seed: int, device, seqs, arch,
            controls=()) -> Dict:
    """The widest logit gap of the architecture's reference
    (``arch.Reference``) over the served tokens of ``seqs`` [(prompt,
    served tokens)]; with ``controls``, also the gaps of the tokens that
    each control (the reference one step down in precision) would put
    first, under ``controls``."""
    if not seqs:
        return {"gap": math.inf, "mean": math.inf, "differ": 0, "tokens": 0}
    from pbench.tokens import encode
    ids = [np.concatenate([encode(p), np.asarray(o[:-1], np.int64)])
           for p, o in seqs]
    first = [len(encode(p)) - 1 for p, _ in seqs]
    served = [np.asarray(o, np.int64) for _, o in seqs]
    with torch.no_grad():
        ref = arch.Reference(m, seed, mix["serving"]["kv_mode"], device)
        ref.calibrate(calib_batches(m, seed))
        lg = ref.logits(ids, first)
        out = reference.widest_gap(lg, served)
        out["controls"] = {}
        for key in controls:
            cl = ref.logits(ids, first, **CONTROLS[key])
            picks = [c.argmax(dim=-1).cpu().numpy() for c in cl]
            out["controls"][key] = reference.widest_gap(lg, picks)
            del cl
    return out


def _records(st, inner, state, items, m, mix, device, t0, t1) -> Dict:
    """What the per-layer readers read (see ``layers.py``)."""
    ev = inner.events
    epoch = inner._epoch
    steps = [dict(e["args"], step=e["step"], wall=epoch + e["wall"])
             for e in ev if e["name"] == "STEP"]
    ps = mix["serving"]["page_size"]
    chunks = [(e["step"], e["rid"], e["args"]["tokens"], e["args"]["done"])
              for e in ev if e["name"] == "CHUNK"]
    shared = {e["rid"]: min(e["args"]["shared_pages"] * ps,
                            e["args"]["prompt_tokens"])
              for e in ev if e["name"] == "ADMITTED"}
    c0, l0 = state["at_open"]
    c1, l1 = state["at_close"]
    span = state["span"]
    return {
        "m": m, "kv_mode": mix["serving"]["kv_mode"], "window": (t0, t1),
        "device": device.type,
        "all_steps": steps,
        "steps": [s for s in steps if t0 < s["wall"] <= t1],
        "counters": {k: c1[k] - c0.get(k, 0) for k in c1},
        "launches": l1 - l0,
        "tokens": st.tokens, "chunks": chunks, "shared": shared,
        "docs": {rid: it.doc for rid, it in enumerate(items)},
        "prompt_tokens": {rid: it.prompt_tokens for rid, it in enumerate(items)},
        "profile": span.reduce() if span is not None and span.t1 else None,
    }


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))
