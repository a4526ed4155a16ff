"""Continuous-batching scheduler over a paged KV pool — counterpart of
``repro/serve/scheduler.py``, line for line in its decisions so the port's
token streams and step counters match the reference engine's.

  * FIFO admission with prefix sharing (common prompt prefixes map the
    same refcounted pages);
  * multi-slot chunked paged prefill, interleaved with the pooled decode:
    each step advances up to ``prefill_slots`` prefilling slots by one
    ``prefill_chunk``-token chunk each in ONE call over one row per
    advancing slot (in ascending slot order; each row carries its own page
    table, start and write window), picked shortest-remaining-first with
    an aging credit;
  * one decode call per step for the whole pool with a per-slot position
    vector, reading only the bucketed page budget of the longest live
    sequence (chunk and page budgets bucket to powers of two);
  * copy-on-write before a decode token lands in a shared page;
  * self-speculative decoding (``spec_mode="ngram"``): a host-side
    prompt-lookup proposer drafts up to ``spec_k - 1`` tokens per live
    slot from its own history (:mod:`repro_torch.serve.spec`), one verify
    call scores every slot's ``[slot, k]`` block, and greedy acceptance
    keeps each slot's longest agreeing draft prefix;
  * preemption of the sequence holding the longest token range when the
    pool is exhausted, with true chunk-boundary resume for mid-prefill
    victims (their written pages travel with the queue entry).

The scheduler's state is host-side numpy; device tensors are built only
at the step call sites.  The flight recorder (``recorder=``) and the
quality observer's pool sampling (``quality=``) run host-side between
step calls, at the reference's hook sites: every hook that would build
an args dict is guarded by ``recorder.enabled``.  With a recorder, the
host's time is cut into phases at the step's boundaries
(:class:`repro_torch.obs.trace.StepPhases`): each ``STEP`` record carries
them as ``host_ms``, and a running profiler sees them as ``serve/<phase>``
ranges.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data import tokenizer as tok
from repro_torch.obs.trace import NULL_RECORDER, StepPhases
from repro_torch.serve import spec
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PagePool, bucket_pow2


@dataclasses.dataclass
class _Slot:
    req: object
    submit_t: float
    ids: np.ndarray             # the token ids this slot prefills with
    arrive_step: int            # step clock when the request first arrived
    seq: int                    # admission order (prefill tie-break)
    prefilling: bool = True
    pre_pos: int = 0            # next prompt position to compute
    pre_start: int = 0          # where this slot's chunked compute began
    write_from: int = 0         # first position not covered by shared pages
    # full known token stream (prompt + generated), the n-gram proposer's
    # lookup corpus — the last entry is the next decode input
    hist: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _QEntry:
    """One queued (or requeued) request and what its admission needs."""
    req: object
    arrive: int                     # arrival-step gate (0 for requeues)
    submit_t: Optional[float] = None
    arrive_step: int = 0
    # mid-prefill true resume: (detached page ids, pre_pos, write_from)
    resume: Optional[tuple] = None


class Scheduler:
    """Drives a request set to completion against one :class:`PagePool`.

    ``prefill_fn(tokens [rows, C], kv, page_table [rows, pb], start,
    write_lo, write_hi) -> (next_tokens [rows, C], kv)``, where the rows are
    the slots that advance a chunk this step, in ascending slot order, and
    ``decode_fn(tokens [n_slots, 1], kv, page_table, pos) ->
    (next_tokens [n_slots], kv)`` and ``verify_fn(tokens [n_slots, k], kv,
    page_table, pos, n_valid) -> (next_tokens [n_slots, k], kv)`` (needed
    when ``spec_mode != "off"``) take device tensors."""

    def __init__(self, pool: PagePool, prefill_fn: Callable,
                 decode_fn: Callable, verify_fn: Optional[Callable] = None,
                 *, eos: int = tok.EOS,
                 metrics: Optional[ServeMetrics] = None,
                 prefix_sharing: bool = True, prefill_chunk: int = 32,
                 prefill_slots: int = 2, prefill_aging: float = 1.0,
                 spec_mode: str = "off", spec_k: int = 4,
                 recorder=None, quality=None):
        self.pool = pool
        self.prefill = prefill_fn
        self.decode = decode_fn
        self.verify = verify_fn
        self.eos = eos
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # flight recorder (repro_torch.obs.trace): NULL_RECORDER = tracing
        # off, every hook an immediate no-op; all recording is host-side,
        # between step calls
        self.rec = recorder if recorder is not None else NULL_RECORDER
        self._ph: Optional[StepPhases] = None    # the step's host phases
        self.quality = quality       # optional repro_torch.obs.quality observer
        self._rids: dict = {}        # id(request) -> trace rid (submit order)
        self.prefix_sharing = prefix_sharing
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_slots < 1:
            raise ValueError(f"prefill_slots must be >= 1, got {prefill_slots}")
        if prefill_aging < 0:
            raise ValueError(f"prefill_aging must be >= 0, got {prefill_aging}")
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_slots = int(prefill_slots)
        self.prefill_aging = float(prefill_aging)
        if spec_mode not in spec.SPEC_MODES:
            raise ValueError(f"unknown spec_mode {spec_mode!r} "
                             f"(expected one of {spec.SPEC_MODES})")
        if spec_mode != "off" and verify_fn is None:
            raise ValueError("spec_mode needs a verify_fn (the multi-token "
                             "verify step)")
        if spec_mode != "off" and spec_k < 2:
            raise ValueError(f"spec_k must be >= 2, got {spec_k}")
        self.spec_mode = spec_mode
        self.spec_k = int(spec_k)
        self._step = 0
        n = pool.n_slots
        self.slots: List[Optional[_Slot]] = [None] * n
        self.pos = np.zeros(n, np.int32)
        self.last_tok = np.zeros(n, np.int32)
        self._admit_seq = 0
        self._first: dict = {}
        self._qw_stamped: set = set()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.pool.device)

    # -- public --------------------------------------------------------------

    def run(self, requests: Sequence, arrivals: Optional[Sequence[int]] = None):
        """Run all requests to completion; ``arrivals`` (one step index per
        request) gates admission."""
        m = self.metrics
        m.start()
        m.cow_baseline = self.pool.cow_count
        if arrivals is None:
            arrivals = [0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError(f"{len(requests)} requests but {len(arrivals)} "
                             "arrival steps")
        for req in requests:
            need = len(self._request_ids(req)) + 1
            if need > self.pool.capacity and not req.out_tokens:
                raise ValueError(
                    f"prompt of {need - 1} tokens exceeds slot capacity "
                    f"{self.pool.capacity - 1} (raise s_max)")
        # trace rids in submit order (stable across preemption/requeue:
        # keyed by request identity)
        for req in requests:
            self._rids.setdefault(id(req), len(self._rids))
        queue = collections.deque(
            _QEntry(req, int(arr)) for req, arr in
            sorted(zip(requests, arrivals), key=lambda p: p[1]))
        m.submitted += len(requests)
        self._ph = StepPhases() if self.rec.enabled else None
        try:
            self._run_loop(queue, 0)
        except BaseException:
            # leave the engine's pool clean for the next run
            for i, s in enumerate(self.slots):
                if s is not None:
                    self.pool.release(i)
                    self.slots[i] = None
                    self.pos[i] = 0
            for e in queue:
                if e.resume is not None:
                    self.pool.drop_detached(e.resume[0])
                    e.resume = None
            raise
        finally:
            if self._ph is not None:
                self._ph.close()        # leaves no profiler range open
        m.stop()
        return list(requests)

    def _run_loop(self, queue, step_clock: int) -> None:
        m, rec, ph = self.metrics, self.rec, self._ph
        while queue or any(self.slots):
            if ph is not None:
                ph.mark("admit")
            self._step = step_clock
            now = None
            for entry in queue:
                if entry.submit_t is None and entry.arrive <= step_clock:
                    entry.submit_t = now = now or time.perf_counter()
                    entry.arrive_step = step_clock
                    self._first[id(entry.req)] = {
                        "tok0": m.prefill_chunk_tokens, "own": 0}
                    if rec.enabled:
                        rid = self._rids[id(entry.req)]
                        rec.instant(rid, "QUEUED", "SUBMITTED", step_clock)
                        rec.begin(rid, "QUEUED", step_clock)
            self._admit(queue, step_clock)
            m.live_slots_peak = max(
                m.live_slots_peak, sum(s is not None for s in self.slots))
            if not any(self.slots):
                if ph is not None:
                    ph.mark("tail")
                if queue:
                    step_clock += 1
                    continue
                break

            cow0 = self.pool.cow_count      # step-record COW delta baseline
            # the step-record info of the chunks that ran (slots and
            # buckets), or None
            did_prefill = self._prefill_chunk_step(step_clock)
            if ph is not None:
                ph.mark("pages")
            # n-gram drafts first (host-side, no pool effects), so the
            # page-backing pass can cover each slot's whole k-token write
            drafts = (self._propose_drafts()
                      if self.spec_mode != "off" else {})
            self._ensure_pages(
                queue, {i: 1 + len(d) for i, d in drafts.items()})
            active = [i for i, s in enumerate(self.slots)
                      if s is not None and not s.prefilling]
            # page-backing may have preempted (or finished) a drafted slot
            drafts = {i: d for i, d in drafts.items() if i in set(active)}
            decode_ran = False
            verify_k = None
            bucket = 0
            if active:
                counts = self.pool.live_page_counts()
                bucket = self.pool.bucket_pages(max(int(counts[i])
                                                    for i in active))
                prefilling = [i for i, s in enumerate(self.slots)
                              if s is not None and s.prefilling]
                if prefilling:
                    # mid-prefill slots sit decode out: a zeroed table row
                    # routes their write to scratch page 0
                    table = self.pool.page_table[:, :bucket].copy()
                    table[prefilling] = 0
                    table = self._dev(table)
                else:
                    table = self.pool.table()[:, :bucket].contiguous()
                if drafts:
                    verify_k = self._verify_step(active, drafts, table,
                                                 bucket, did_prefill,
                                                 step_clock)
                else:
                    if ph is not None:
                        ph.mark("decode_enqueue")
                    nxt, new_kv = self.decode(
                        self._dev(self.last_tok)[:, None], self.pool.state(),
                        table, self._dev(self.pos))
                    if ph is not None:
                        ph.mark("decode_readback")
                    self.pool.adopt(new_kv)
                    outs = nxt.cpu().numpy()
                    if ph is not None:
                        ph.mark("decode_post")
                    m.decode_steps += 1
                    m.decode_slot_steps += len(active)
                    m.record_read(self.pool, bucket)
                    if did_prefill:
                        m.interleaved_steps += 1
                    for i in active:
                        self.pos[i] += 1
                        self._post_token(i, int(outs[i]))
                decode_ran = True
            if active and not decode_ran:
                m.decode_stall_steps += 1
            if rec.enabled:
                # one scheduler record per active step: what ran and what
                # it cost
                pf = did_prefill or {}
                pf_slots = pf.get("slots", [])
                rec.step_record(
                    step_clock, decode_ran=decode_ran, slots=len(active),
                    page_bucket=bucket if decode_ran else 0,
                    verify_k=verify_k or 0,
                    prefill_slots=pf_slots,
                    prefill_slot=pf_slots[0] if pf_slots else None,
                    chunk_bucket=pf.get("chunk_bucket", 0),
                    prefill_page_bucket=pf.get("page_bucket", 0),
                    cow=self.pool.cow_count - cow0, host_ms=ph.close())
                ph.open()
            if self.quality is not None:
                self.quality.maybe_sample_pool(self.pool, step_clock)
            step_clock += 1
            live = {i: (int(self.pos[i]) if not s.prefilling else s.pre_pos)
                    for i, s in enumerate(self.slots) if s}
            m.sample_pool(self.pool.stats(live))

    # -- admission -----------------------------------------------------------

    def _request_ids(self, req) -> np.ndarray:
        """Prefill ids: the prompt, plus — after a preemption — every
        generated token but the last (the next decode input)."""
        ids = tok.encode(req.prompt)
        if req.out_tokens:
            ids = np.concatenate(
                [ids, np.asarray(req.out_tokens[:-1], np.int32)])
        return ids

    def _shared_prefix(self, ids: np.ndarray):
        """Best prefix-share candidate among live slots: (src_slot,
        shared_pages, write_from, pending)."""
        if not self.prefix_sharing:
            return None, 0, 0, False
        ps = self.pool.page_size
        best, best_c = None, 0
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            src = st.ids
            n = min(len(src), len(ids))
            c = int((np.cumprod(src[:n] == ids[:n])).sum())
            if c > best_c:
                best, best_c = i, c
        n_full = best_c // ps
        partial = best_c == len(ids) and best_c % ps != 0
        n_share = n_full + (1 if partial else 0)
        if best is None or n_share == 0:
            return None, 0, 0, False
        st = self.slots[best]
        written = st.pre_pos if st.prefilling else len(st.ids)
        if written < (best_c if partial else n_full * ps):
            return None, 0, 0, True
        if not np.all(self.pool.page_table[best, :n_share] > 0):
            return None, 0, 0, False
        write_from = len(ids) if partial else n_full * ps
        return best, n_share, write_from, False

    def _reclaim_detached(self, queue) -> bool:
        """Drop the largest detached-page reservation among queued entries."""
        best = None
        for e in queue:
            if e.resume is not None and (
                    best is None or len(e.resume[0]) > len(best.resume[0])):
                best = e
        if best is None:
            return False
        self.pool.drop_detached(best.resume[0])
        best.resume = None
        return True

    def _admit(self, queue, step_clock: int) -> None:
        while queue and queue[0].arrive <= step_clock:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            entry = queue[0]
            req = entry.req
            ids = self._request_ids(req)
            if len(ids) + 1 > self.pool.capacity:
                if req.out_tokens:      # resumed at capacity: done, truncated
                    queue.popleft()
                    req.done = True
                    self.metrics.completed += 1
                    self._stamp_finish(req, entry.arrive_step, step_clock)
                    if self.rec.enabled:
                        rid = self._rids[id(req)]
                        self.rec.end(rid, "QUEUED", step_clock)
                        self.rec.instant(rid, "DECODING", "FINISHED",
                                         step_clock, truncated=True)
                    continue
                raise ValueError(
                    f"prompt of {len(ids)} tokens exceeds slot capacity "
                    f"{self.pool.capacity - 1} (raise s_max)")
            slot = free[0]
            resume_from = None
            if entry.resume is not None:
                n_share = 0
                kept, r_pre, write_from = entry.resume
                admitted = self.pool.readmit(slot, len(ids), kept)
                if admitted:
                    entry.resume = None
                    resume_from = r_pre
                    self.metrics.prefill_resumes += 1
            else:
                src, n_share, write_from, pending = self._shared_prefix(ids)
                if pending:
                    return          # FIFO: wait for the source's chunks
                admitted = self.pool.admit(slot, len(ids), share_from=src,
                                           shared_pages=n_share)
            if not admitted:
                if not any(self.slots):
                    if self._reclaim_detached(queue):
                        continue
                    raise ValueError(
                        f"pool exhausted with no live sequences: {len(ids)} "
                        f"tokens need {self.pool.pages_needed(len(ids))} "
                        f"pages, {self.pool.pages_free} free")
                return
            queue.popleft()
            st = _Slot(req, entry.submit_t, ids, entry.arrive_step,
                       self._admit_seq)
            self._admit_seq += 1
            fresh = not req.out_tokens
            if fresh and id(req) not in self._qw_stamped:
                self._qw_stamped.add(id(req))
                try:
                    req.queue_wait_steps = step_clock - entry.arrive_step
                except AttributeError:
                    pass
                self.metrics.observe("queue_wait_steps",
                                     step_clock - entry.arrive_step)
            if self.rec.enabled:
                rid = self._rids[id(req)]
                self.rec.end(rid, "QUEUED", step_clock)
                self.rec.instant(rid, "PREFILLING", "ADMITTED", step_clock,
                                 slot=slot, prompt_tokens=len(ids),
                                 pages=self.pool.pages_needed(len(ids)),
                                 shared_pages=n_share, replay=not fresh,
                                 resume_from=resume_from or 0)
                self.rec.begin(rid, "PREFILLING", step_clock, slot=slot)
            st.write_from = write_from
            # proposer corpus: prompt + every generated token (a resumed
            # request's last token is the next decode input — ids stop one
            # short of it, the stream does not)
            st.hist = [int(t) for t in ids]
            if req.out_tokens:
                st.hist.append(int(req.out_tokens[-1]))
            if resume_from is not None:
                st.pre_pos = resume_from
            elif write_from < len(ids):
                st.pre_pos = write_from
            elif fresh:
                st.pre_pos = len(ids) - 1
            else:
                st.pre_pos = len(ids)
            st.pre_start = st.pre_pos
            self.slots[slot] = st
            self.pos[slot] = 0
            self.last_tok[slot] = 0
            if n_share:
                self.metrics.prefix_hits += 1
                self.metrics.shared_pages_mapped += n_share
            if st.pre_pos >= len(ids):          # resumed, fully shared
                self._activate(slot, None, step_clock)

    # -- chunked prefill -----------------------------------------------------

    def _prefill_pick(self, cands, step_clock: int):
        """Shortest-remaining-first with an aging credit; admission order
        breaks ties.  Returns the top ``prefill_slots``."""
        def key(j):
            st = self.slots[j]
            remaining = len(st.ids) - st.pre_pos
            waited = step_clock - st.arrive_step
            return (remaining - self.prefill_aging * waited, st.seq)
        return sorted(cands, key=key)[: self.prefill_slots]

    def _prefill_chunk_step(self, step_clock: int) -> Optional[dict]:
        """Advance up to ``prefill_slots`` prefilling slots by one bucketed
        chunk each, in ONE call over a ``[rows, C]`` block: one row per
        advancing slot, in ascending slot order (no idle rows).  Returns the
        step-record info (slots and buckets) when chunks ran, else None."""
        cands = [i for i, s in enumerate(self.slots)
                 if s is not None and s.prefilling]
        if not cands:
            return None
        ph = self._ph
        if ph is not None:
            ph.mark("prefill_build")
        chosen = self._prefill_pick(cands, step_clock)
        m = self.metrics
        m.prefill_wait_steps_max = max(
            m.prefill_wait_steps_max,
            max(step_clock - self.slots[j].arrive_step for j in cands))
        ns = {}
        for j in chosen:
            st = self.slots[j]
            ns[j] = min(self.prefill_chunk, len(st.ids) - st.pre_pos)
        cb = bucket_pow2(max(ns.values()), self.prefill_chunk)
        ps = self.pool.page_size
        pb = self.pool.bucket_pages(max(
            math.ceil((self.slots[j].pre_pos + cb) / ps) for j in chosen))
        rows = sorted(ns)               # row r carries slot rows[r]
        toks = np.zeros((len(rows), cb), np.int32)
        start = np.zeros(len(rows), np.int32)
        w_lo = np.zeros(len(rows), np.int32)
        w_hi = np.zeros(len(rows), np.int32)
        tab = self.pool.page_table[rows, :pb]
        for r, j in enumerate(rows):
            st, n = self.slots[j], ns[j]
            done = st.pre_pos
            toks[r, :n] = st.ids[done:done + n]
            start[r] = done
            w_lo[r] = max(done, st.write_from)
            w_hi[r] = min(done + n, len(st.ids))
        args = (self._dev(toks), self.pool.state(), self._dev(tab),
                self._dev(start), self._dev(w_lo), self._dev(w_hi))
        if ph is not None:
            ph.mark("prefill_enqueue")
        nxt, new_kv = self.prefill(*args)
        if ph is not None:
            ph.mark("prefill_readback")
        self.pool.adopt(new_kv)
        outs = nxt.cpu().numpy()
        if ph is not None:
            ph.mark("prefill_post")
        m.prefill_steps += 1
        m.prefill_computed_tokens += len(rows) * cb
        if len(ns) > 1:
            m.prefill_multi_steps += 1
        row_of = {j: r for r, j in enumerate(rows)}
        for j, n in ns.items():
            st = self.slots[j]
            m.prefill_chunks += 1
            m.prefill_chunk_tokens += n
            first = self._first.get(id(st.req))
            if first is not None:
                first["own"] += n
            st.pre_pos += n
            if self.rec.enabled:
                self.rec.instant(self._rids[id(st.req)], "PREFILLING",
                                 "CHUNK", step_clock, slot=j, tokens=n,
                                 chunk_bucket=cb, page_bucket=pb,
                                 done=st.pre_pos, total=len(st.ids))
            if st.pre_pos >= len(st.ids):
                self._activate(j, int(outs[row_of[j], n - 1]), step_clock)
        return {"slots": rows, "chunk_bucket": cb, "page_bucket": pb}

    def _activate(self, slot: int, sampled: Optional[int],
                  step_clock: int) -> None:
        """Prefill complete: the slot joins the pooled decode."""
        st = self.slots[slot]
        st.prefilling = False
        self.pos[slot] = len(st.ids)
        m = self.metrics
        m.prefills += 1
        fresh = not st.req.out_tokens
        if self.rec.enabled:
            rid = self._rids[id(st.req)]
            self.rec.end(rid, "PREFILLING", step_clock)
            # DECODING opens BEFORE the first token posts, so a one-token
            # request's FINISHED lands inside an open DECODING span
            self.rec.begin(rid, "DECODING", step_clock, slot=slot)
            if fresh:
                self.rec.instant(rid, "DECODING", "FIRST_TOKEN", step_clock,
                                 ttft_steps=step_clock - st.arrive_step)
        if fresh:
            ttft = time.perf_counter() - st.submit_t
            m.ttft_s.append(ttft)
            m.ttft_steps.append(step_clock - st.arrive_step)
            m.observe("ttft_steps", step_clock - st.arrive_step)
            first = self._first.get(id(st.req), {
                "tok0": 0, "own": len(st.ids) - st.pre_start})
            waited = (m.prefill_chunk_tokens - first["tok0"] - first["own"])
            for name, val in (("ttft_s", ttft),
                              ("ttft_steps", step_clock - st.arrive_step),
                              ("ttft_prefill_tokens", waited)):
                try:
                    setattr(st.req, name, val)
                except AttributeError:
                    pass
            self._post_token(slot, int(sampled))
            if self.slots[slot] is None:
                return                  # one-token request: done at prefill
        self.last_tok[slot] = st.req.out_tokens[-1]

    # -- speculative decoding -------------------------------------------------

    def _propose_drafts(self) -> dict:
        """Host-side n-gram drafts for every live decode slot, clamped so a
        slot's 1 + draft tokens never outrun its cache capacity or its
        ``max_new_tokens`` budget.  Empty when nothing matches: the step
        then runs the plain one-token decode."""
        drafts = {}
        for i, st in enumerate(self.slots):
            if st is None or st.prefilling:
                continue
            room_cap = self.pool.capacity - int(self.pos[i]) - 1
            room_out = st.req.max_new_tokens - len(st.req.out_tokens) - 1
            max_draft = min(self.spec_k - 1, room_cap, room_out)
            if max_draft <= 0:
                continue
            d = spec.propose_ngram(st.hist, max_draft)
            if d:
                drafts[i] = d
        return drafts

    def _verify_step(self, active, drafts, table, bucket, did_prefill,
                     step_clock: int) -> int:
        """One batched verify over the pool: every active slot's committed
        token + draft rides a ``[slot, k]`` block (k bucketed to pow2);
        greedy acceptance emits each slot's longest agreeing draft prefix
        plus the model's own next token.  Per-slot ``pos`` advances only
        over emitted tokens; rejected page rows are overwritten later.
        Returns the k bucket."""
        m = self.metrics
        kb = bucket_pow2(1 + max(len(d) for d in drafts.values()),
                         self.spec_k)
        n = self.pool.n_slots
        toks = np.zeros((n, kb), np.int32)
        n_valid = np.zeros(n, np.int32)
        for i in active:
            d = drafts.get(i, [])
            toks[i, 0] = self.last_tok[i]
            if d:
                toks[i, 1:1 + len(d)] = d
            n_valid[i] = 1 + len(d)
        ph = self._ph
        if ph is not None:
            ph.mark("verify_enqueue")
        nxt, new_kv = self.verify(
            self._dev(toks), self.pool.state(), table, self._dev(self.pos),
            self._dev(n_valid))
        if ph is not None:
            ph.mark("verify_readback")
        self.pool.adopt(new_kv)
        outs = nxt.cpu().numpy()                # [n_slots, kb]
        if ph is not None:
            ph.mark("verify_post")
        m.decode_steps += 1
        m.decode_slot_steps += len(active)
        m.spec_verify_steps += 1
        m.record_read(self.pool, bucket)
        if did_prefill:
            m.interleaved_steps += 1
        for i in active:
            d = drafts.get(i, [])
            acc = spec.accept_length(d, outs[i])
            m.spec_proposed += len(d)
            m.spec_accepted += acc
            m.decode_steps_saved += acc
            if d:
                m.observe("accepted_draft_len", acc)
                if self.rec.enabled:
                    self.rec.instant(self._rids[id(self.slots[i].req)],
                                     "VERIFY", "VERIFY", step_clock,
                                     slot=i, k_bucket=kb, proposed=len(d),
                                     accepted=acc)
            # emitted stream = accepted draft prefix + the model's own
            # next token after it — exactly sequential greedy decode
            for t in outs[i, :acc + 1]:
                self.pos[i] += 1
                self._post_token(i, int(t))
                if self.slots[i] is None:
                    break                       # EOS / budget mid-block
        return kb

    # -- paging / preemption --------------------------------------------------

    def _ensure_pages(self, queue, spans: Optional[dict] = None) -> None:
        """Back every live decode slot's next write position(s) with
        private pages; on exhaustion preempt the slot holding the longest
        token range and retry.  ``spans`` widens a slot's write window to
        a speculative k-token block (positions ``pos .. pos+span-1`` may
        cross a page boundary; every touched page is made private before
        the write, or a rejected draft row would corrupt a prefix-sharing
        sibling)."""
        spans = spans or {}
        ps = self.pool.page_size
        for i in range(len(self.slots)):
            if self.slots[i] is None or self.slots[i].prefilling:
                continue
            if self.pos[i] >= self.pool.capacity:
                self._finish(i)
                continue
            lo = int(self.pos[i]) // ps
            hi = (int(self.pos[i]) + spans.get(i, 1) - 1) // ps
            for page_idx in range(lo, hi + 1):
                while self.slots[i] is not None \
                        and not self.pool.ensure_writable(i, page_idx):
                    live = [j for j, s in enumerate(self.slots)
                            if s is not None]
                    victim = max(live, key=self._held_tokens)
                    free0 = self.pool.pages_free
                    self._preempt(victim, queue)
                    if self.pool.pages_free <= free0:
                        self._reclaim_detached(queue)
                if self.slots[i] is None:
                    break               # preempted while backing its pages

    def _held_tokens(self, slot: int) -> int:
        st = self.slots[slot]
        return len(st.ids) if st.prefilling else int(self.pos[slot])

    def _preempt(self, slot: int, queue) -> None:
        st = self.slots[slot]
        resume = None
        if st.prefilling:
            valid = max(st.pre_pos, min(st.write_from, len(st.ids)))
            if valid > 0:
                kept = self.pool.detach_prefix(slot, valid)
                resume = (kept, st.pre_pos, st.write_from)
        if self.rec.enabled:
            rid = self._rids[id(st.req)]
            phase = "PREFILLING" if st.prefilling else "DECODING"
            self.rec.end(rid, phase, self._step, preempted=True)
            self.rec.instant(rid, phase, "PREEMPTED", self._step, slot=slot,
                             held_tokens=self._held_tokens(slot),
                             kept_pages=len(resume[0]) if resume else 0)
            # the request re-queues: its replay admission ends this span
            self.rec.begin(rid, "QUEUED", self._step)
        if resume is None:
            self.pool.release(slot)
        self.slots[slot] = None
        self.pos[slot] = 0
        self.metrics.preemptions += 1
        queue.appendleft(_QEntry(st.req, 0, st.submit_t, st.arrive_step,
                                 resume=resume))

    # -- token bookkeeping ----------------------------------------------------

    def _post_token(self, slot: int, token: int) -> None:
        st = self.slots[slot]
        req = st.req
        req.out_tokens.append(token)
        st.hist.append(token)
        self.last_tok[slot] = token
        self.metrics.tokens_out += 1
        stream = getattr(req, "stream", None)
        if stream is not None:
            stream(token)
        if token == self.eos or len(req.out_tokens) >= req.max_new_tokens:
            self._finish(slot)

    def _stamp_finish(self, req, arrive_step: int, step_clock: int) -> None:
        e2e = step_clock - arrive_step
        try:
            req.e2e_steps = e2e
        except AttributeError:
            pass
        self.metrics.observe("e2e_steps", e2e)
        self.metrics.observe("request_decode_steps", len(req.out_tokens))

    def _finish(self, slot: int) -> None:
        st = self.slots[slot]
        st.req.done = True
        self._stamp_finish(st.req, st.arrive_step, self._step)
        if self.rec.enabled:
            rid = self._rids[id(st.req)]
            self.rec.instant(rid, "DECODING", "FINISHED", self._step,
                             tokens=len(st.req.out_tokens))
            self.rec.end(rid, "DECODING", self._step)
        self.pool.release(slot)
        self.slots[slot] = None
        self.pos[slot] = 0
        self.metrics.completed += 1
