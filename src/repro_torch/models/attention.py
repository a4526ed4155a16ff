"""Paged attention steps of the dense decoder (counterpart of the paged
part of ``repro/models/attention.py``).

Both steps project QKV through the quantization ctx (``attn_qkv``), apply
RoPE, quantize the new K/V through the pool's page mode, scatter them into
the slot's pages, read every slot's key range through the page table with
``repro_torch.kernels.paged_attention`` and project the result
(``attn_out``).  Writes into the pool arrays happen IN PLACE (the pool
holds one copy of every page; the reference's functional ``.at[].set``
would copy the whole pool per write).  Positions that must not land in a
slot's pages (idle slots, chunk padding, prefix-shared positions) route to
the reserved scratch page 0, which is never read back for a live row.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.models.common import ModelConfig, apply_rope
from repro_torch.serve import kvq

NEG_INF = -1e9


def _split_qkv(cfg: ModelConfig, qkv: torch.Tensor):
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = qkv.shape
    q = qkv[..., : h * dh].reshape(b, s, h, dh)
    k = qkv[..., h * dh: (h + kv) * dh].reshape(b, s, kv, dh)
    v = qkv[..., (h + kv) * dh:].reshape(b, s, kv, dh)
    return q, k, v


def _project_qkv(cfg, p, ctx, x, positions):
    qkv = ctx("attn_qkv", x, p["wqkv"])
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].to(x.dtype)
    q, k, v = _split_qkv(cfg, qkv)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _scatter(cache: dict, parts: dict, page_idx: torch.Tensor,
             offset: torch.Tensor) -> None:
    """In-place page write: parts[n] [b, s, kvh, *] -> cache[n][page, off]."""
    for n, val in parts.items():
        cache[n][page_idx, offset] = val.to(cache[n].dtype)


def _read(cfg, window_flag, q, cache, page_table, pos, quantizer):
    win = cfg.window_size if window_flag else PA.NO_WINDOW
    return PA.paged_attention_decode(
        q, cache["k"], cache["v"], page_table, pos, window=win,
        softcap=cfg.attn_softcap, **quantizer.kernel_operands(cache))


def attention_decode_paged(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor,
                           cache: dict, *, window_flag: bool = False
                           ) -> Tuple[torch.Tensor, dict]:
    """Pool-wide one-token decode.  x [b, 1, d]; ``cache`` holds one
    layer's pages (k/v [n_pages, ps, kvh, dh], int8 pages add
    k/v_scale [n_pages, ps, kvh, 1]) plus ``page_table`` [b, P] int32 and
    ``pos`` [b] int32 (per-slot position; slots need not be aligned).
    The new K/V land in page ``page_table[b, pos // ps]`` at offset
    ``pos % ps``."""
    b = x.shape[0]
    pos, page_table = cache["pos"], cache["page_table"]
    ps = cache["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, ctx, x, pos[:, None])
    quantizer = kvq.from_cache(cache)
    page_idx = torch.gather(page_table, 1, (pos // ps)[:, None].long())[:, 0]
    _scatter(cache, {n: t[:, 0] for n, t in quantizer.quantize(k, v).items()},
             page_idx.long(), (pos % ps).long())
    o = _read(cfg, window_flag, q[:, 0], cache, page_table, pos, quantizer)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return ctx("attn_out", o, p["wo"]), cache


def attention_prefill_paged(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor,
                            cache: dict, *, window_flag: bool = False
                            ) -> Tuple[torch.Tensor, dict]:
    """One prompt chunk per prefilling slot, for several slots at once.
    x [b, C, d]; ``cache`` holds one layer's pages plus ``page_table``
    [b, P] int32 and ``start`` / ``write_lo`` / ``write_hi`` [b] int32:
    each slot's chunk start and the absolute-position window whose K/V is
    written to its pages (everything else goes to scratch page 0).  The
    chunk's K/V are written first, then one kernel call attends every
    slot's key range with a per-slot start-offset causal mask."""
    b, C, _ = x.shape
    ps = cache["k"].shape[1]
    start, w_lo, w_hi = cache["start"], cache["write_lo"], cache["write_hi"]
    page_table = cache["page_table"]
    p_abs = start[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=x.device)[None]     # [b, C]
    q, k, v = _project_qkv(cfg, p, ctx, x, p_abs)
    quantizer = kvq.from_cache(cache)
    writable = (p_abs >= w_lo[:, None]) & (p_abs < w_hi[:, None])
    logical = torch.clamp(p_abs // ps, 0, page_table.shape[1] - 1).long()
    page = torch.gather(page_table, 1, logical)
    page_idx = torch.where(writable, page, torch.zeros_like(page))
    _scatter(cache, quantizer.quantize(k, v), page_idx.long(),
             (p_abs % ps).long())
    o = _read(cfg, window_flag, q, cache, page_table, start, quantizer)
    o = o.reshape(b, C, cfg.n_heads * cfg.head_dim)
    return ctx("attn_out", o, p["wo"]), cache
