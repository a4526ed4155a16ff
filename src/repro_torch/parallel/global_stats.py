"""Batch-global statistics of a loss whose batch is split over
data-parallel ranks.

Under :func:`data_parallel` (the sharded train step installs it), the
loss's denominators and no-grad statistics are summed over the group:
``cross_entropy`` divides each rank's token sum by the global token count,
and the MoE aux loss takes the global top-1 counts and token count.  Each
rank's loss is then its share of the single-device loss, and the sum of
the ranks' gradients is the single-device gradient.  Outside it
:func:`global_sum` returns its argument and the model computes as before.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_GROUP = None
_ACTIVE = False


@contextmanager
def data_parallel(group):
    """Sum the loss's global statistics over ``group`` inside the block."""
    global _GROUP, _ACTIVE
    prev = _GROUP, _ACTIVE
    _GROUP, _ACTIVE = group, True
    try:
        yield
    finally:
        _GROUP, _ACTIVE = prev


def active() -> bool:
    return _ACTIVE


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel group (a detached copy; no
    gradient flows through a statistic), or ``x`` itself outside
    :func:`data_parallel`."""
    if not _ACTIVE:
        return x
    from repro_torch.parallel.collectives import all_reduce
    return all_reduce(x.detach().clone(), "sum", _GROUP)
