"""Rehearse a traffic mix on the CPU, with the program's scheduler and
page pool and stand-in step functions (no model), and write what it finds
into the mix's file under ``rehearsal``:

  * ``hold_steps``: the mean steps a request holds a slot, from its
    admission to its last token, at the offered rate (found by two
    rounds from a first guess of a step a chunk and a step a token);
  * ``slot_capacity_per_step``: slots / ``hold_steps``;
  * ``rate_per_step``: ``load`` x that capacity, the rate the cell offers;
  * after a stationary start, ``start_steps``: where the arrivals begin,
    half the steps it takes to prefill the requests in flight at step 0
    (they start to answer halfway through on average, so arrivals from
    there keep the live slots nearest their steady mean);
  * ``warmup_steps``: the steps, at that rate, until the live slots first
    reach nine tenths of their mean over the rest of the rehearsal (the
    documents of a documents mix are prefilled by then); after a
    stationary start, also until the requests in flight at step 0 are
    all prefilled, and until no later
    request waits longer for its first token than any does in the
    rehearsal's second half;
  * the queue wait's 95th percentile and mean live slots in the first and
    second half of the rehearsal, which show whether a backlog grows.

    python3 perfbench/rehearse.py [mix ...]      (default: every mix)
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

import torch  # noqa: E402

from pbench import cells, traffic  # noqa: E402

HORIZON = 1500          # rehearsed steps at the offered rate


def _scheduler(mix):
    from repro_torch.models.common import ModelConfig
    from repro_torch.serve.pool import PagePool
    from repro_torch.serve.scheduler import Scheduler

    s = mix["serving"]
    tiny = ModelConfig(name="stand-in", n_layers=1, d_model=2, n_heads=1,
                       n_kv_heads=1, d_ff=2, vocab_size=512)
    pool = PagePool(tiny, s["max_batch"], s["s_max"], page_size=s["page_size"],
                    mode="fp", dtype=torch.float32, device="cpu")

    def prefill(tokens, kv, table, start, lo, hi):
        return torch.zeros(tokens.shape, dtype=torch.int64), kv

    def decode(tokens, kv, table, pos):
        return torch.zeros(tokens.shape[0], dtype=torch.int64), kv

    return Scheduler(pool, prefill, decode, prefix_sharing=s["prefix_sharing"],
                     prefill_chunk=s["prefill_chunk"],
                     prefill_slots=s["prefill_slots"])


class _Live:
    """Counts live slots and arrival steps from the scheduler's records."""
    enabled = True
    dropped = 0

    def __init__(self, sched):
        self.sched, self.live, self.arrive = sched, [], {}

    def instant(self, rid, phase, name, step, **args):
        if name == "SUBMITTED":
            self.arrive[rid] = step

    def step_record(self, step, **args):
        self.live.append((step, sum(s is not None for s in self.sched.slots)))

    def begin(self, *a, **k):
        pass

    end = compile_event = set_metadata = begin


def _serve(mix, items):
    from repro_torch.serve.engine import Request
    sched = _scheduler(mix)
    rec = _Live(sched)
    sched.rec = rec
    reqs = [Request(it.prompt, max_new_tokens=it.max_new_tokens)
            for it in items]
    sched.run(reqs, [it.arrive_step for it in items])
    return reqs, rec


def _hold(mix, items, reqs, lo):
    """Mean steps from admission to the last token of the requests that
    arrived from step ``lo`` on and finished."""
    return statistics.mean(r.e2e_steps - r.queue_wait_steps + 1
                           for it, r in zip(items, reqs)
                           if it.arrive_step >= lo and r.done)


def rehearse(mix):
    slots = mix["serving"]["max_batch"]
    chunk = mix["serving"]["prefill_chunk"]
    block = traffic.master_block(mix)
    # first guess: every chunk and every token a step of its own
    hold = statistics.mean(-(-int(p) // chunk) + int(o)
                           for p, o in zip(block["prompt"], block["output"]))
    for _ in range(2):
        rate = mix["load"] * slots / hold
        items = traffic.generate(mix, 0, HORIZON, rate_per_step=rate,
                                 start_steps=0)
        reqs, rec = _serve(mix, items)
        hold = _hold(mix, items, reqs, HORIZON // 3)
    cap = slots / hold
    rate = mix["load"] * cap
    start = {}
    if mix.get("start") == "stationary":
        items = traffic.generate(mix, 0, HORIZON, rate_per_step=rate,
                                 start_steps=HORIZON)
        reqs, _ = _serve(mix, items)
        prefilled = 1 + max(r.ttft_steps for r in reqs)
        start["start_steps"] = prefilled // 2
    items = traffic.generate(mix, 0, HORIZON, rate_per_step=rate, **start)
    reqs, rec = _serve(mix, items)
    live = [n for step, n in rec.live if step < HORIZON]
    mean_live = statistics.mean(live[len(live) // 3:])
    warm = next(step for step, n in rec.live if n >= 0.9 * mean_live)
    if mix.get("start") == "stationary":
        steady = max(r.ttft_steps for it, r in zip(items, reqs)
                     if it.arrive_step >= HORIZON // 2 and r.done)
        late = [it.arrive_step for it, r in zip(items, reqs)
                if it.arrive_step < HORIZON // 2
                and (r.ttft_steps is None or r.ttft_steps > steady)]
        warm = max([warm, prefilled] + [a + 1 for a in late])
    halves = {}
    mid = (warm + HORIZON) // 2
    for half, (lo, hi) in (("first", (warm, mid)), ("second", (mid, HORIZON))):
        waits = [r.queue_wait_steps for it, r in zip(items, reqs)
                 if lo <= it.arrive_step < hi]
        occ = [n for step, n in rec.live if lo <= step < hi]
        halves[half] = {
            "queue_wait_steps_p95": statistics.quantiles(waits, n=20)[-1],
            "live_slots_mean": statistics.mean(occ)}
    return {"hold_steps": hold, "slot_capacity_per_step": cap,
            "rate_per_step": rate, **start, "warmup_steps": int(warm) + 1,
            "rehearsed_steps": HORIZON, **halves}


def main(names) -> None:
    for name in names or sorted(p.stem for p in (HERE / "traffic").glob("*.json")):
        path = HERE / "traffic" / f"{name}.json"
        raw = json.loads(path.read_text())
        found = rehearse(cells.mix(name))
        raw["rehearsal"] = found
        path.write_text(json.dumps(raw, indent=2) + "\n")
        print(name, json.dumps(found))


if __name__ == "__main__":
    main(sys.argv[1:])
