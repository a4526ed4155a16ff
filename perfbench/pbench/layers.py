"""What the per-layer readers share: the traced run's records reduced to
the work each scheduler step served, and the rooflines and peak shares
reckoned on the yardstick.

A step's work is counted from what the scheduler did, not from what the
program computed: the decode rows of the slots that got a token, the
prompt tokens of each chunk, the key positions each query attends and
the distinct cached positions each call reads (a document's pages that
several slots share count once a call).
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional

from pbench import yardstick as Y


def step_work(records: Dict) -> Dict[int, Dict]:
    """step -> {"decode": [(rid, keys)], "chunks": [(rid, n, start)],
    "first": tokens whose logits came from a prefill}, over every step
    record of the run."""
    steps = records["all_steps"]
    walls = [s["wall"] for s in steps]
    work = {s["step"]: {"decode": [], "chunks": [], "first": 0} for s in steps}
    prompt = records["prompt_tokens"]
    for rid, stamps in records["tokens"].items():
        for j, t in enumerate(stamps):
            i = bisect.bisect_left(walls, t)
            if i == len(steps):
                continue
            w = work[steps[i]["step"]]
            if j == 0:
                w["first"] += 1
            else:
                w["decode"].append((rid, prompt[rid] + j))
    for step, rid, n, done in records["chunks"]:
        if step in work:
            work[step]["chunks"].append((rid, n, done - n))
    return work


def _distinct(entries, shared: Dict[int, int], docs: Dict[int, int]) -> int:
    """Distinct positions read by (rid, positions) entries of one call:
    a document's shared prefix counts once."""
    own, groups = 0, {}
    for rid, pos in entries:
        sp = min(shared.get(rid, 0), pos)
        doc = docs.get(rid, -1)
        if doc >= 0 and sp > 0:
            own += pos - sp
            groups[doc] = max(groups.get(doc, 0), sp)
        else:
            own += pos
    return own + sum(groups.values())


def _profiled(records: Dict):
    prof = records.get("profile")
    if not prof or prof["first_step"] is None:
        return None, []
    work = step_work(records)
    steps = [w for s, w in work.items()
             if prof["first_step"] <= s <= prof["last_step"]]
    return prof, steps


def kernel_seconds(prof: Dict, layer: str) -> float:
    return sum(s for name, s in prof["by_name"].items()
               if Y.kernel_layer(name) == layer)


def gemm_roofline(records: Dict) -> Optional[float]:
    """Percent: the profiled steps' GEMM calls at their bound (useful rows,
    published K and N), over the profiled time of the GEMM kernels."""
    prof, steps = _profiled(records)
    if prof is None:
        return None
    took = kernel_seconds(prof, "muxq_gemm")
    if took <= 0:
        return None
    m = records["m"]
    bound = 0.0
    for w in steps:
        for rows in (len(w["decode"]), sum(n for _, n, _ in w["chunks"])):
            if rows:
                bound += m["n_layers"] * sum(
                    Y.bound_s(Y.gemm_cost(rows, k, n))
                    for k, n in Y.site_kn(m).values())
    return 100.0 * bound / took


def attention_calls(records: Dict, w: Dict) -> List[Dict]:
    """The one layer's paged-attention costs of a step: its decode call
    and its prefill call."""
    m = records["m"]
    h, dh = m["n_heads"], m["d_model"] // m["n_heads"]
    per_pos = Y.kv_bytes_per_position(m, records["kv_mode"])
    shared, docs = records["shared"], records["docs"]
    calls = []
    if w["decode"]:
        keys = sum(k for _, k in w["decode"])
        calls.append(Y.paged_cost(len(w["decode"]), keys, h, dh,
                                  _distinct(w["decode"], shared, docs), per_pos))
    if w["chunks"]:
        queries = sum(n for _, n, _ in w["chunks"])
        keys = sum(n * s + n * (n + 1) // 2 for _, n, s in w["chunks"])
        reach = [(rid, s + n) for rid, n, s in w["chunks"]]
        calls.append(Y.paged_cost(queries, keys, h, dh,
                                  _distinct(reach, shared, docs), per_pos))
    return calls


def attention_roofline(records: Dict) -> Optional[float]:
    prof, steps = _profiled(records)
    if prof is None:
        return None
    took = kernel_seconds(prof, "paged_attention")
    if took <= 0:
        return None
    bound = sum(Y.bound_s(c) for w in steps
                for c in attention_calls(records, w)) * records["m"]["n_layers"]
    return 100.0 * bound / took


def idle_share(records: Dict) -> Optional[float]:
    prof = records.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def step_mfu(records: Dict) -> Optional[float]:
    """Percent of the traced window the card would need, at its
    data-sheet peaks, for the model's work in the window's steps."""
    if records.get("device") != "cuda":
        return None
    t0, t1 = records["window"]
    work = step_work(records)
    inside = [s["step"] for s in records["all_steps"] if t0 < s["wall"] <= t1]
    tokens = head = keys = 0
    for s in inside:
        w = work[s]
        tokens += len(w["decode"]) + sum(n for _, n, _ in w["chunks"])
        head += len(w["decode"]) + w["first"]
        keys += (sum(k for _, k in w["decode"])
                 + sum(n * st + n * (n + 1) // 2 for _, n, st in w["chunks"]))
    if not tokens:
        return None
    return Y.peak_share(Y.model_ops(records["m"], tokens, head, keys), t1 - t0)


def step_ms(records: Dict) -> Optional[float]:
    """Mean host gap between consecutive step records, over the window's
    steps that ran a prefill chunk, outside the profiled stretch.  A mean,
    since the steps with and without a chunk differ several times over
    and a median would jump between the two."""
    prof = records.get("profile") or {}
    lo, hi = prof.get("first_step"), prof.get("last_step")
    steps = records["steps"]
    gaps = []
    for a, b in zip(steps, steps[1:]):
        if lo is not None and lo <= b["step"] <= hi + 1:
            continue
        if b.get("prefill_slots"):
            gaps.append(1e3 * (b["wall"] - a["wall"]))
    return statistics.fmean(gaps) if gaps else None


def ratio(records: Dict, num: str, den: str) -> Optional[float]:
    c = records["counters"]
    return c[num] / c[den] if c.get(den) else None


def launches_per_step(records: Dict) -> Optional[float]:
    n = records.get("launches")
    steps = len(records["steps"])
    return n / steps if n and steps else None
