"""The benchmark's frozen yardstick: the H100's data-sheet peaks, the work
of each kernel call reckoned from its shapes, and the table that maps the
profiler's device operations to the program's layers.

The cost arithmetic is a copy of the program's ``kernels/accounting.py``
and the peaks of its ``analysis/roofline.py``, frozen here so that a
change to the program cannot move the ruler it is measured with.  Every
count is of useful work: the rows a step actually served and each site's
published, unpadded K and N, whatever the implementation computes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK = {"int8": 1979e12,        # OP/s, int8 tensor cores
        "f32": 67e12}           # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # B/s

# device operation name -> layer; the first pattern that the (lower-cased)
# name contains wins, and anything else is "other"
KERNEL_LAYERS: List[Tuple[str, str]] = [
    ("muxq_gemm", "muxq_gemm"),
    ("rowwise_quantize", "rowwise_quantize"),
    ("paged_attention", "paged_attention"),
    ("flash_attention", "flash_attention"),
]


def kernel_layer(name: str) -> str:
    low = name.lower()
    for pattern, layer in KERNEL_LAYERS:
        if pattern in low:
            return layer
    return "other"


def gemm_cost(m: int, k: int, n: int) -> Dict:
    """Int8 GEMM X [m, k] @ W [k, n]: both operands read once, one f32
    scale a row and a column, the f32 output written once."""
    return {"ops": 2 * m * n * k, "kind": "int8",
            "bytes": m * k + k * n + 4 * (m + n) + 4 * m * n}


def paged_cost(queries: int, keys_attended: int, h: int, dh: int,
               positions_read: int, kv_bytes_per_position: int) -> Dict:
    """Paged attention: ``queries`` query rows of h heads (f32 in and out)
    against ``keys_attended`` (query, key) pairs in all, and
    ``positions_read`` distinct cached positions read once; 4·dh
    operations a (query, key, head)."""
    return {"ops": 4 * dh * h * keys_attended, "kind": "f32",
            "bytes": 2 * 4 * queries * h * dh
            + positions_read * kv_bytes_per_position}


def bound_s(cost: Dict) -> float:
    """The least time the card could take: the larger of operations over
    the kind's peak and bytes over HBM bandwidth."""
    return max(cost["ops"] / PEAK[cost["kind"]], cost["bytes"] / HBM_BW)


def kv_bytes_per_position(m: Dict, kv_mode: str) -> int:
    """Page bytes one cached position costs in one layer (K and V, with
    their scales): int8 a value and an f32 scale a head, int4 half a byte
    a value and a bf16 scale a head."""
    kv, dh = m["n_kv_heads"], m["d_model"] // m["n_heads"]
    if kv_mode == "int8":
        return 2 * kv * (dh + 4)
    if kv_mode == "int4":
        return 2 * kv * (dh // 2 + 2)
    raise ValueError(f"no page bytes for kv mode {kv_mode!r}")


def site_kn(m: Dict) -> Dict[str, Tuple[int, int]]:
    """Published K and N of a layer's four matmul sites."""
    d, h, kv, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    dh = d // h
    up = 2 * f if m["mlp_type"] == "swiglu" else f
    return {"attn_qkv": (d, (h + 2 * kv) * dh), "attn_out": (h * dh, d),
            "mlp_up": (d, up), "mlp_down": (f, d)}


def model_ops(m: Dict, tokens: int, head_tokens: int,
              keys_attended: int) -> Dict[str, float]:
    """The model's operations by kind: 2 x the matmul weights a token
    passes (the int8 sites, every layer), 2 x the f32 LM head for the
    tokens whose logits are used, and attention's 4·dh·h a (query, key)
    in every layer."""
    per_token = sum(k * n for k, n in site_kn(m).values()) * m["n_layers"]
    dh = m["d_model"] // m["n_heads"]
    return {"int8": 2.0 * per_token * tokens,
            "f32": (2.0 * m["d_model"] * m["vocab_size"] * head_tokens
                    + 4.0 * dh * m["n_heads"] * keys_attended
                    * m["n_layers"])}


def peak_share(ops: Dict[str, float], seconds: float) -> Optional[float]:
    """Percent of the window the card would need at its peaks."""
    if seconds <= 0:
        return None
    return 100.0 * sum(v / PEAK[k] for k, v in ops.items()) / seconds
