"""Process-global activation-sharding constraint and KV-cache write mode —
counterpart of ``repro/parallel/act_sharding.py``.

The model stack is mesh-agnostic; a launcher installs a residual-stream
spec (batch over dp, optionally seq over model = Megatron-SP) that every
block body applies at its entry (``transformer._block``, ``_mamba_block``,
``_decoder_block``), and ``models.moe`` applies the expert-sharding spec
to its dispatch buffer the same way.  Plain module state, as in the
reference.  A constraint acts on a DTensor only: it lays the tensor out
by the spec (``sharding.reshard``); a plain tensor, an unset spec or a
rank mismatch pass through unchanged, as the reference's does unset.
"""
from __future__ import annotations

from contextlib import contextmanager

_SPEC = None


def set_activation_sharding(spec) -> None:
    global _SPEC
    _SPEC = spec


@contextmanager
def activation_sharding(spec):
    global _SPEC
    prev = _SPEC
    _SPEC = spec
    try:
        yield
    finally:
        _SPEC = prev


def constrain_to(x, spec):
    """``x`` laid out by ``spec`` when it is a DTensor of that rank (the
    counterpart of ``jax.lax.with_sharding_constraint``); else ``x``."""
    from torch.distributed.tensor import DTensor
    if spec is None or not isinstance(x, DTensor) or x.ndim != len(spec):
        return x
    from repro_torch.parallel.sharding import reshard, spec_of
    return x if spec_of(x) == tuple(spec) else reshard(x, spec)


def constrain(x):
    """Apply the installed constraint to a [b, s, d] activation (no-op when
    unset, on a rank mismatch or on a plain tensor)."""
    if _SPEC is None:
        return x
    return constrain_to(x, _SPEC)


_CACHE_UPDATE = "dus"


def set_cache_update_mode(mode: str) -> None:
    """"dus" (an indexed write at the position) or "select" (an elementwise
    ``where(arange == pos)``, which stays local to a shard of a
    sequence-sharded cache)."""
    global _CACHE_UPDATE
    if mode not in ("dus", "select"):
        raise ValueError(f"cache update mode must be 'dus' or 'select', "
                         f"not {mode!r}")
    _CACHE_UPDATE = mode


def cache_update_mode() -> str:
    return _CACHE_UPDATE
