"""The benchmark's own stamps at the scheduler's boundaries.

The program's scheduler reports to a recorder object: an arrival
(``SUBMITTED``), each prefill chunk (``CHUNK``), each admission
(``ADMITTED``) and one record at the end of every active step.
:class:`Stamps` takes those calls and keeps only host clock stamps and the
step records, and calls ``on_step`` after each step, which is where the
harness opens and closes its window and its profile.  With ``inner`` (the
program's own flight recorder, in the traced run) every call is passed
on, and the per-layer readers take the step records from it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class Stamps:
    enabled = True
    dropped = 0

    def __init__(self, inner=None):
        self.inner = inner
        self.arrive: Dict[int, float] = {}          # rid -> host clock
        self.tokens: Dict[int, List[float]] = {}    # rid -> token stamps
        self.steps: List[Dict] = []
        self.on_step: Optional[Callable[[Dict], None]] = None

    # the recorder interface the scheduler and engine call
    def begin(self, rid, phase, step, **args):
        if self.inner is not None:
            self.inner.begin(rid, phase, step, **args)

    def end(self, rid, phase, step, **args):
        if self.inner is not None:
            self.inner.end(rid, phase, step, **args)

    def instant(self, rid, phase, name, step, **args):
        if name == "SUBMITTED":
            self.arrive[rid] = time.perf_counter()
        if self.inner is not None:
            self.inner.instant(rid, phase, name, step, **args)

    def step_record(self, step, **args):
        if self.inner is not None:
            self.inner.step_record(step, **args)
        rec = dict(args, step=step, wall=time.perf_counter())
        self.steps.append(rec)
        if self.on_step is not None:
            self.on_step(rec)

    def compile_event(self, kind, **args):
        if self.inner is not None:
            self.inner.compile_event(kind, **args)

    def set_metadata(self, **kw):
        if self.inner is not None:
            self.inner.set_metadata(**kw)

    def stream(self, rid: int) -> Callable[[int], None]:
        """A request's ``stream`` callback: one stamp a token."""
        stamps = self.tokens.setdefault(rid, [])
        return lambda _token: stamps.append(time.perf_counter())
