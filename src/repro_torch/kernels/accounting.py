"""The work of each kernel site, reckoned from its shapes, for the
dry-run's counts (``repro_torch.analysis.hlo.CostCounter``).

Each kernel's entry point (``quantize.rowwise_quantize``,
``muxq_gemm.muxq_gemm``, ``paged_attention.paged_attention_decode``) runs
its call inside :func:`site`.  With a counter installed
(:func:`install`), the counter adds the site's operations and bytes as
:func:`quantize_cost`, :func:`gemm_cost` and :func:`paged_cost` reckon
them (each input read once, each output written once, as
``chip_smoke.py``'s bounds count them) and leaves out the aten ops that
run inside, so that the counts are the same whichever implementation runs:
the CUDA kernel, or the plain version on a CPU or a meta tensor.  With
none installed a site costs one global read.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

_COUNTER = None
_NULL = contextlib.nullcontext()


def install(counter):
    """Install (or clear, with None) the counter; returns the previous."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, counter
    return prev


def site(name: str, cost: Callable[[], Dict]):
    """The context a kernel entry point runs its call in: the installed
    counter's ``kernel(name, cost())``, or a no-op."""
    counter = _COUNTER
    return _NULL if counter is None else counter.kernel(name, cost())


def quantize_cost(m: int, k_in: int, k_out: int, x_bytes: int,
                  fused: bool) -> Dict:
    """Row-wise quantize of x [m, k_in] (the MUXQ body gathered to k_out
    channels when ``fused``): x read, int8 codes and f32 scales written,
    the int32 map and f32 multipliers read; about 4 f32 operations an
    output element (abs, max, scale, round)."""
    return {"ops": 4 * m * k_out, "kind": "f32",
            "bytes": (m * k_in * x_bytes + (8 * k_out if fused else 0)
                      + m * k_out + 4 * m)}


def gemm_cost(m: int, k: int, n: int, bk: int) -> Dict:
    """Block-scaled int8 GEMM, X [m, k] @ W [k, n]: both operands, the
    block scales and the two f32 scale vectors read once, the f32 output
    written once; 2·m·n·k int8 operations."""
    return {"ops": 2 * m * n * k, "kind": "int8",
            "bytes": m * k + k * n + 4 * (k // bk + m + n) + 4 * m * n}


def paged_cost(b: int, sq: int, h: int, dh: int, q_bytes: int,
               keys: int, kv_bytes_per_key: int) -> Dict:
    """Paged attention of b slots x sq query rows x h heads over ``keys``
    positions a slot (the page table's width x the page size: on a meta
    tensor the positions are unknown, so every key of the table counts):
    q read, the output written, each slot's K and V pages (with their
    scales) read once; 4·dh operations a (query, key, head)."""
    return {"ops": 4 * dh * h * b * sq * keys, "kind": "f32",
            "bytes": 2 * b * sq * h * dh * q_bytes + b * keys
            * kv_bytes_per_key}
