"""Shard plan and scoped shard context for tensor-parallel paged serving,
over ``torch.distributed`` — counterpart of
``repro/parallel/serve_sharding.py``.

Serving runs SPMD: each rank is one process on one device, holds the full
replicated weights, its contiguous run of ``kvh / tp`` KV heads in the
page pool and ``V_pad / tp`` columns of the LM head, and runs the same
host-side scheduler on the same inputs.  Because the merged logits are
replicated, every rank makes the same scheduling decisions.  K/V pages
``[L, n_pages, ps, kvh, dh]`` (and their int8/int4 scales) split on the
kvh axis, the int4 redistribution rows ``[L, kvh, dh]`` on theirs; page
tables, positions and tokens stay replicated and the scheduler never sees
the group.  Per-(position, head) page scales and per-head redistribution
rows are head-local, so quantize and dequantize never cross a shard.

Two layers of API, as in the reference:

  * **Shard plan** (host side): :func:`serve_group` checks the process
    group (a clear error when it is missing or of another size);
    :func:`pool_specs` maps every pool array's global shape to a spec
    through :func:`fit_spec` — a kvh the group does not divide drops the
    axis and the whole pool falls back to replicated placement
    (:func:`heads_sharded` False; the engine then serves with no
    collectives).
  * **Scoped shard context** (step time): the engine wraps each step in
    :func:`head_sharding`, and the paged attention and logits seams
    consult :func:`active`.

Bit-exactness of the collectives: attention outputs and logits merge with
a **zero-pad all-reduce** — each rank writes its slice into a full-width
zero buffer at its own offset and one ``all_reduce(SUM)`` adds exact
zeros to every element, so the order of the sum cannot matter and the
streams at tp = 2 or 4 equal those at tp = 1.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as SH

SERVE_AXIS = "model"

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """This rank's place in the serving group: ``rank`` of ``size``, and
    the group its collectives run over (None: the default group)."""
    rank: int = 0
    size: int = 1
    group: Any = None


_ACTIVE: Optional[HeadShard] = None


def active() -> Optional[HeadShard]:
    """The HeadShard the engine installed around the current step (None
    when serving on one device or on the replicated fallback)."""
    return _ACTIVE


@contextmanager
def head_sharding(shard: Optional[HeadShard]):
    """Scoped install of the shard context around a step, so engines at
    tp = 1 and tp > 1 coexist in one process."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = shard
    try:
        yield
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# Group and pool specs (host side)
# ---------------------------------------------------------------------------

def serve_group(tp: int, group=None):
    """The process group a ``tp``-rank serve runs over (the counterpart of
    ``serve_mesh``): ``group``, or the default group, once it is checked
    to be initialized with exactly ``tp`` ranks."""
    if tp < 1:
        raise ValueError(f"serving group size must be >= 1, got {tp}")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"tensor-parallel serving at tp={tp} needs an initialized "
            f"torch.distributed process group of {tp} ranks: launch with "
            f"`python -m repro_torch.launch.serve --tp {tp}`, or call "
            f"torch.distributed.init_process_group(world_size={tp}, ...) "
            "in every rank first")
    size = dist.get_world_size(group)
    if tp != size:
        raise ValueError(
            f"requested a {tp}-rank serving group but the process group "
            f"has {size} rank(s): lower --tp to {size}, or call "
            f"torch.distributed.init_process_group with world_size={tp}")
    return group if group is not None else dist.group.WORLD


def fit_spec(size: int, shape: Sequence[int], wanted: Sequence) -> Spec:
    """A spec over one serving axis of ``size`` ranks: each dim keeps the
    axis it wants only where ``size`` divides it (``sharding.fit_spec`` on
    a 1-D mesh, as the reference's)."""
    return SH.fit_spec({SERVE_AXIS: size}, shape, wanted)


def pool_specs(size: int, shapes: Dict[str, Sequence[int]]) -> Dict[str, Spec]:
    """Spec per pool array (by its GLOBAL shape), sharding the KV-head axis.

    Page arrays ``[L, n_pages, ps, kvh, dh|1]`` (K/V and their scales)
    carry kvh on axis 3; per-head pool state ``[L, kvh, dh]`` (the int4
    redistribution rows) on axis 1; anything else is replicated."""
    specs: Dict[str, Spec] = {}
    for name, shape in shapes.items():
        if len(shape) == 5:
            wanted = [None, None, None, SERVE_AXIS, None]
        elif len(shape) == 3:
            wanted = [None, SERVE_AXIS, None]
        else:
            wanted = [None] * len(shape)
        specs[name] = fit_spec(size, shape, wanted)
    return specs


def heads_sharded(specs: Optional[Dict[str, Spec]]) -> bool:
    """True when the K pages carry the serving axis (``fit_spec`` kept it):
    the sharded-versus-replicated-fallback discriminator."""
    spec = (specs or {}).get("k")
    return spec is not None and SERVE_AXIS in spec


def shard_shape(shape: Sequence[int], spec: Spec, size: int) -> Tuple[int, ...]:
    """The shape one rank holds of a global ``shape`` under ``spec``."""
    return tuple(d // size if ax == SERVE_AXIS else d
                 for d, ax in zip(shape, spec))


def local_part(t: torch.Tensor, spec: Spec, shard: HeadShard) -> torch.Tensor:
    """This rank's contiguous copy of a global tensor under ``spec``."""
    for axis, ax in enumerate(spec):
        if ax == SERVE_AXIS:
            n = t.shape[axis] // shard.size
            t = t.narrow(axis, shard.rank * n, n)
    return t.contiguous()


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of this rank's part of a pool array (each rank holds only its
    part, so this is the tensor's own size)."""
    return t.numel() * t.element_size()


def global_bytes(t: torch.Tensor, spec: Optional[Spec], size: int) -> int:
    """Bytes of the whole array that ``t`` is this rank's part of."""
    return local_bytes(t) * (size if spec and SERVE_AXIS in spec else 1)


# ---------------------------------------------------------------------------
# Step-time helpers (inside the engine's head_sharding scope)
# ---------------------------------------------------------------------------

def slice_heads(x: torch.Tensor, shard: HeadShard) -> torch.Tensor:
    """This rank's contiguous slice of the head axis of ``[b, s, H, dh]``
    (a view).  Works for q and k/v alike: GQA orders q heads as
    ``kvh_index * group + j``, so ``H // size`` heads at offset
    ``rank * H // size`` are exactly the q heads of this rank's KV heads."""
    hl = x.shape[2] // shard.size
    return x.narrow(2, shard.rank * hl, hl)


def all_heads(o: torch.Tensor, n_heads: int, shard: HeadShard) -> torch.Tensor:
    """Per-rank attention outputs ``[..., h_local, dh]`` back to the full
    head axis, bit-exactly: written into a zero buffer at this rank's
    offset, then summed over the group (every element is one rank's value
    plus exact zeros)."""
    hl = o.shape[-2]
    full = o.new_zeros(o.shape[:-2] + (n_heads, o.shape[-1]))
    full.narrow(-2, shard.rank * hl, hl).copy_(o)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=shard.group)
    return full


def tp_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The LM-head matmul, split by vocabulary columns over the active
    shard: each rank computes its contiguous column slice (each column's
    contraction over d_model is unchanged by the slice) and the zero-pad
    all-reduce reassembles the full logits on every rank.  No active
    shard, or a ``V_pad`` the group does not divide, computes the full
    matmul."""
    shard = active()
    V = head.shape[1]
    if shard is None or shard.size == 1 or V % shard.size:
        return x @ head
    vl = V // shard.size
    part = x @ head.narrow(1, shard.rank * vl, vl)
    full = part.new_zeros(x.shape[:-1] + (V,))
    full.narrow(-1, shard.rank * vl, vl).copy_(part)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=shard.group)
    return full
