"""What the readers of the scheduler's host phases share.

With a recorder, the program's scheduler cuts the host's time between two
``STEP`` records into phases and hands them over as the record's
``host_ms`` (``{phase: ms}``, the phases that ran).  The device is
drained in every phase but the ``*_enqueue`` ones and the readbacks,
which wait on it.  A program without them gives no ``host_ms``, and
each reader then returns nothing.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

DRAINED = ("tail", "admit", "prefill_build", "prefill_post", "pages",
           "decode_post", "verify_post")
ENQUEUE = ("prefill_enqueue", "decode_enqueue", "verify_enqueue")


def mean_ms(records: Dict, phases: Iterable[str],
            ran: Optional[str] = None) -> Optional[float]:
    """Mean over the window's steps of the sum of ``phases`` in each
    step's ``host_ms``; with ``ran``, over the steps in which that phase
    ran.  Like ``layers.step_ms`` it leaves out the profiled steps and the
    step after them, whose host time the profiler and its stop hold."""
    prof = records.get("profile") or {}
    lo, hi = prof.get("first_step"), prof.get("last_step")
    phases = tuple(phases)
    sums = []
    for s in records["steps"]:
        host = s.get("host_ms")
        if not host or (ran is not None and ran not in host):
            continue
        if lo is not None and lo <= s["step"] <= hi + 1:
            continue
        sums.append(sum(host.get(p, 0.0) for p in phases))
    mean = statistics.fmean(sums) if sums else 0.0
    return mean if mean > 0 else None
