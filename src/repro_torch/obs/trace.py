"""Serve-stack flight recorder: ring-buffered spans + instant events.

Counterpart of ``repro/obs/trace.py``.  The scheduler (and engine) record
per-request lifecycle spans and per-step scheduler records HOST-SIDE,
between step calls, never inside one; every event carries both the
deterministic **step clock** (the scheduler's pooled-step counter, the
number CI can gate on) and the wall clock (what a trace viewer lays the
spans out by).

Lifecycle model (pid = request, tid = phase):

  SUBMITTED -> [QUEUED span] -> ADMITTED -> [PREFILLING span: CHUNK events]
  -> [DECODING span: FIRST_TOKEN, VERIFY events] -> FINISHED
  with PREEMPTED closing the live span and a later replay re-entering
  PREFILLING (a resumed request re-prefills in chunks).

Scheduler-wide records ride pid ``SCHED_RID`` (= -1): one ``STEP`` instant
per active step (slots decoded, prefill slot + chunk bucket, page-budget
bucket, spec verify k, COW copies) and a ``COMPILE`` instant every time a
``decode_traces`` / ``prefill_traces`` / ``verify_traces`` counter grows
(in the port: the first step call of a new bucket key, see
``repro_torch.serve.engine``).

Two consumers:

  * :meth:`TraceRecorder.export_chrome` — Chrome-trace / Perfetto JSON
    (load in https://ui.perfetto.dev or chrome://tracing);
  * :meth:`TraceRecorder.events` — the plain event list the tests assert
    span-ordering invariants on (:func:`lifecycle_errors`).

Tracing must cost nothing when off: :data:`NULL_RECORDER` is a shared
no-op whose methods return immediately, and every call site that would
build an args dict guards on ``recorder.enabled`` first.  The buffer is a
bounded ring (``capacity`` events; the oldest drop, ``dropped`` counts
them), so a long-lived engine can leave tracing on without growing.
"""
from __future__ import annotations

import collections
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

SCHED_RID = -1                       # the scheduler's pseudo-request id

# phase -> chrome tid (stable small ints so exported traces line up per pid)
PHASES = ("QUEUED", "PREFILLING", "DECODING", "VERIFY", "SCHED")
TIDS = {p: i + 1 for i, p in enumerate(PHASES)}

# span phases a request moves through; instants ride their current phase
SPAN_PHASES = ("QUEUED", "PREFILLING", "DECODING")


class NullRecorder:
    """The tracing-off recorder: every method is an immediate no-op.

    Call sites MUST NOT build args dicts before checking :attr:`enabled` —
    that is the whole no-per-step-allocation contract."""

    enabled = False
    dropped = 0

    def begin(self, rid, phase, step, **args):
        pass

    def end(self, rid, phase, step, **args):
        pass

    def instant(self, rid, phase, name, step, **args):
        pass

    def step_record(self, step, **args):
        pass

    def compile_event(self, kind, **args):
        pass

    def set_metadata(self, **kw):
        pass

    @property
    def events(self):
        return []


NULL_RECORDER = NullRecorder()


class TraceRecorder:
    """Ring-buffered host-side event recorder (see module docstring)."""

    enabled = True

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events = collections.deque(maxlen=capacity)
        self._epoch = time.perf_counter()
        self.dropped = 0
        self.metadata: Dict[str, object] = {}

    # -- recording -----------------------------------------------------------

    def _push(self, kind, rid, phase, name, step, args) -> None:
        if phase not in TIDS:
            raise ValueError(f"unknown phase {phase!r} (one of {PHASES})")
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append({
            "kind": kind, "rid": int(rid), "phase": phase, "name": name,
            "step": None if step is None else int(step),
            "wall": time.perf_counter() - self._epoch,
            "args": args,
        })

    def begin(self, rid, phase, step, **args) -> None:
        """Open a lifecycle span (phase in SPAN_PHASES) for request rid."""
        self._push("B", rid, phase, phase, step, args)

    def end(self, rid, phase, step, **args) -> None:
        self._push("E", rid, phase, phase, step, args)

    def instant(self, rid, phase, name, step, **args) -> None:
        """A point event on request rid's ``phase`` track."""
        self._push("I", rid, phase, name, step, args)

    def step_record(self, step, **args) -> None:
        """One scheduler record per active step: slots decoded, prefill
        slot/chunk bucket, page-budget bucket, verify k, COW copies."""
        self._push("I", SCHED_RID, "SCHED", "STEP", step, args)

    def compile_event(self, kind, **args) -> None:
        """A retrace: an engine ``*_traces`` counter grew (kind names which
        — 'decode' / 'prefill' / 'verify')."""
        self._push("I", SCHED_RID, "SCHED", "COMPILE", None,
                   dict(args, kind=kind))

    def set_metadata(self, **kw) -> None:
        """Run-level metadata (e.g. the serving mesh shape) stamped into
        the exported Chrome trace: ``otherData`` keys plus a
        ``process_labels`` badge on every process, so traces recorded at
        different mesh sizes are distinguishable in the viewer."""
        self.metadata.update(kw)

    # -- consumption ---------------------------------------------------------

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def spans(self) -> Dict[int, List[dict]]:
        """Per-request closed spans: rid -> [{phase, t0, t1, args}] in begin
        order (t0/t1 are step-clock stamps).  Unmatched begins (ring drop or
        still-open span) are omitted."""
        open_: Dict[tuple, dict] = {}
        out: Dict[int, List[dict]] = {}
        for ev in self._events:
            key = (ev["rid"], ev["phase"])
            if ev["kind"] == "B":
                open_[key] = {"phase": ev["phase"], "t0": ev["step"],
                              "t1": None, "args": dict(ev["args"])}
                out.setdefault(ev["rid"], []).append(open_[key])
            elif ev["kind"] == "E" and key in open_:
                span = open_.pop(key)
                span["t1"] = ev["step"]
                span["args"].update(ev["args"])
        return out

    def export_chrome(self, path) -> Path:
        """Write Chrome-trace / Perfetto JSON.  pid = request (rid + 1, so
        the scheduler's pseudo-request lands on pid 0), tid = phase.  ``ts``
        is wall-clock microseconds since the recorder's epoch; the step
        clock rides every event's args as ``step``."""
        events = []
        pids_seen, tids_seen = set(), set()
        for ev in self._events:
            pid, tid = ev["rid"] + 1, TIDS[ev["phase"]]
            pids_seen.add((pid, ev["rid"]))
            tids_seen.add((pid, tid, ev["phase"]))
            args = dict(ev["args"])
            if ev["step"] is not None:
                args["step"] = ev["step"]
            rec = {"name": ev["name"], "ph": ev["kind"],
                   "pid": pid, "tid": tid,
                   "ts": round(ev["wall"] * 1e6, 3), "args": args}
            if ev["kind"] == "I":
                rec["ph"] = "i"
                rec["s"] = "t"          # thread-scoped instant
            events.append(rec)
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": "scheduler" if rid == SCHED_RID
                          else f"request-{rid}"}}
                for pid, rid in sorted(pids_seen)]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": phase}}
                 for pid, tid, phase in sorted(tids_seen)]
        if self.metadata:
            label = ",".join(f"{k}={v}"
                             for k, v in sorted(self.metadata.items()))
            meta += [{"name": "process_labels", "ph": "M", "pid": pid,
                      "args": {"labels": label}}
                     for pid, _rid in sorted(pids_seen)]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
               "otherData": dict(self.metadata,
                                 dropped_events=self.dropped)}
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc) + "\n")
        return path


# ---------------------------------------------------------------------------
# Invariant checking (tests, chip_smoke.py)
# ---------------------------------------------------------------------------

def _request_events(events) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {}
    for ev in events:
        if ev["rid"] != SCHED_RID:
            out.setdefault(ev["rid"], []).append(ev)
    return out


def lifecycle_errors(events: List[dict],
                     decode_steps: Optional[int] = None) -> List[str]:
    """Span-ordering invariants over a recorder's event list; returns
    human-readable violations (empty = well-formed).  Checks, per request
    that FINISHED:

      * step ordering: ADMITTED <= first CHUNK <= FIRST_TOKEN <= FINISHED;
      * spans pair up: every begin has a matching end, none left open;
      * a PREEMPTED request re-enters PREFILLING or DECODING before it
        finishes (unless the finish is the truncated-at-capacity path);

    and, when ``decode_steps`` is given, that the per-step scheduler
    records' decode flags sum exactly to it (observer effect = 0: the trace
    describes the run the metrics counted)."""
    errors: List[str] = []
    for rid, evs in sorted(_request_events(events).items()):
        if not any(e["name"] == "FINISHED" for e in evs):
            continue                    # incomplete request: no invariants
        steps = {}
        for e in evs:
            if e["kind"] == "I" and e["name"] not in steps \
                    and e["step"] is not None:
                steps[e["name"]] = e["step"]
        order = [n for n in ("ADMITTED", "CHUNK", "FIRST_TOKEN", "FINISHED")
                 if n in steps]
        for a, b in zip(order, order[1:]):
            if steps[a] > steps[b]:
                errors.append(f"rid {rid}: {a}@{steps[a]} > {b}@{steps[b]}")
        if "ADMITTED" not in steps:
            errors.append(f"rid {rid}: FINISHED without ADMITTED")
        open_phases: List[str] = []
        for e in evs:
            if e["kind"] == "B":
                if e["phase"] in open_phases:
                    errors.append(f"rid {rid}: nested {e['phase']} span")
                open_phases.append(e["phase"])
            elif e["kind"] == "E":
                if e["phase"] not in open_phases:
                    errors.append(f"rid {rid}: end of unopened "
                                  f"{e['phase']} span")
                else:
                    open_phases.remove(e["phase"])
        if open_phases:
            errors.append(f"rid {rid}: finished with open spans "
                          f"{open_phases}")
        for i, e in enumerate(evs):
            if e["name"] != "PREEMPTED":
                continue
            later = evs[i + 1:]
            reentered = any(x["kind"] == "B" and
                            x["phase"] in ("PREFILLING", "DECODING")
                            for x in later)
            truncated = any(x["name"] == "FINISHED"
                            and x["args"].get("truncated") for x in later)
            if not (reentered or truncated):
                errors.append(f"rid {rid}: PREEMPTED without replay "
                              "re-entering PREFILLING/DECODING")
    if decode_steps is not None:
        recorded = sum(1 for e in events
                       if e["rid"] == SCHED_RID and e["name"] == "STEP"
                       and e["args"].get("decode_ran"))
        if recorded != decode_steps:
            errors.append(f"step records count {recorded} decode steps, "
                          f"metrics counted {decode_steps}")
    return errors


def chrome_errors(path) -> List[str]:
    """Validate an exported Chrome-trace file: JSON parses, and every event
    references only pids/tids that carry a metadata name."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable chrome trace: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return [f"{path}: no traceEvents list"]
    errors = []
    known_pids = {e["pid"] for e in events
                  if e.get("ph") == "M" and e.get("name") == "process_name"}
    known_tids = {(e["pid"], e["tid"]) for e in events
                  if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for e in events:
        if e.get("ph") == "M":
            continue
        if e.get("pid") not in known_pids:
            errors.append(f"event {e.get('name')!r} references unnamed "
                          f"pid {e.get('pid')}")
        elif (e["pid"], e.get("tid")) not in known_tids:
            errors.append(f"event {e.get('name')!r} references unnamed "
                          f"tid {e.get('tid')} on pid {e['pid']}")
    return errors
