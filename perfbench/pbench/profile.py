"""``torch.profiler`` over a stretch of the traced run, reduced to the
device's operations, its busy time and its idle gaps.

``busy_s`` is the union of the intervals in which a device operation
(kernel, copy or fill) ran; ``window_s`` is the host clock from the
profiler's start to its stop.  An idle gap is named by the innermost host
operation that was running at its middle, or ``host`` where none was.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch


# host events of the profiler's own bookkeeping, never a label of a gap
PROFILER_OWN = ("Activity Buffer",)


def warm_up(device) -> None:
    """Start and stop a profile once, so that the tracer's own start-up
    (seconds, the first time in a process) falls in the set-up and not
    in the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Span:
    """Start and stop a profile between two scheduler steps."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self.first_step = self.last_step = None

    def start(self, step: int) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()
        self.first_step = step + 1

    def stop(self, step: int) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.last_step = step

    def reduce(self) -> Dict:
        device: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in self.prof.events():
            tr = e.time_range
            item = (tr.start * 1e-6, tr.end * 1e-6, e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device.append(item)
            elif e.device_type == torch.autograd.DeviceType.CPU \
                    and not e.name.startswith(PROFILER_OWN):
                host.append(item)
        return reduce(device, host, self.t1 - self.t0,
                      self.first_step, self.last_step)


def _union(intervals: List[Tuple[float, float, str]]):
    segs: List[List[float]] = []
    for a, b, _ in sorted(intervals):
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    return segs


def _host_at(host_sorted, starts, t: float) -> str:
    """The innermost (shortest) host operation that covers time t."""
    best, best_len = None, None
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host_sorted[max(0, i - 4000):i]):
        if b >= t and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best or "host"


def reduce(device, host, window_s: float, first_step: Optional[int],
           last_step: Optional[int]) -> Dict:
    by_name: Dict[str, float] = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    segs = _union(device)
    busy = sum(b - a for a, b in segs)
    lo = min([a for a, _, _ in host] + [a for a, _ in segs[:1]], default=0.0)
    hi = max([b for _, b, _ in host] + [b for _, b in segs[-1:]], default=0.0)
    edges = [lo] + [x for s in segs for x in s] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host_sorted = sorted(host)
    starts = [a for a, _, _ in host_sorted]
    idle = [[_host_at(host_sorted, starts, (a + b) / 2), b - a]
            for a, b in gaps[:10]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device": device, "busy_s": busy, "window_s": window_s,
            "by_name": by_name, "first_step": first_step,
            "last_step": last_step,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle}}
