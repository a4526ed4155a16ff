"""GPipe-style pipeline parallelism over a process group — counterpart of
``repro/parallel/pipeline.py``.

The layer stack is split into ``n_stages`` contiguous stages, one a rank
of the group.  Micro-batches stream through the GPipe schedule: at tick
t, stage s processes micro-batch t - s, and its output goes to stage s + 1
by ``isend``/``irecv`` (``collectives``; through host memory where the
backend refuses device pointers), so ``n_micro + S - 1`` ticks run and
the bubble is (S - 1) / (n_micro + S - 1).  The last stage banks its
outputs and broadcasts them to every stage.  A stage idle at a tick (the
reference computes on garbage there and discards it) computes nothing.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel import collectives as C


def pipeline_apply(block_fn: Callable, stage_params, x_micro: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Run the pipeline with the members of ``group`` as its stages.

    block_fn(stage_params, x) -> x    one stage's worth of layers (the
                                      micro-batch's shape kept)
    stage_params: this stage's layers
    x_micro: [n_micro, mb, ...] micro-batched input (only stage 0 reads it)
    Returns [n_micro, mb, ...], the last stage's outputs, on every stage.
    """
    n_stages, stage = C.axis_size(group), C.axis_index(group)
    n_micro = x_micro.shape[0]
    outputs = torch.zeros_like(x_micro)
    sends = []
    for t in range(n_micro + n_stages - 1):
        m = t - stage                  # the micro-batch at this stage now
        if not 0 <= m < n_micro:
            continue
        if stage == 0:
            x_in = x_micro[m]
        else:
            x_in = C.irecv(x_micro[m], stage - 1, group).wait()
        y = block_fn(stage_params, x_in)
        if stage == n_stages - 1:
            outputs[m] = y
        else:
            sends.append(C.isend(y, stage + 1, group))
    for s in sends:
        s.wait()
    return C.broadcast(outputs, n_stages - 1, group)


def split_stages(layers, n_stages: int):
    """A list of per-layer dicts (the port's layers) -> ``n_stages``
    contiguous runs of them; a tree of [L, ...]-stacked tensors (the
    reference's) -> each leaf [n_stages, L / n_stages, ...]."""
    if isinstance(layers, list):
        L = len(layers)
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        k = L // n_stages
        return [layers[i * k:(i + 1) * k] for i in range(n_stages)]
    if isinstance(layers, dict):
        return {key: split_stages(v, n_stages) for key, v in layers.items()}
    L = layers.shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    return layers.reshape(n_stages, L // n_stages, *layers.shape[1:])


def microbatch(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B / n_micro, ...]."""
    B = batch.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "micro-batches")
    return batch.reshape(n_micro, B // n_micro, *batch.shape[1:])
