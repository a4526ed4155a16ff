"""Attention (counterpart of ``repro/models/attention.py``): the
full-sequence ``attention`` of the training, calibration and prefill
forward (causal, or bidirectional for an encoder), whisper's
``cross_attention``, the one-token decode against a dense cache, and the
three paged serving steps.

The dense path (``sdpa`` with a ``causal_bias``) is the reference's op
sequence; it also reports each layer's post-RoPE K/V to an optional
observer (:func:`set_kv_observer`), which is how int4 KV pages calibrate
their per-head outlier channels.  With a dense cache (:func:`init_cache`,
or ``serve.kvcache.init_int8_cache``: ``[b, s_max, kvh, dh]`` a layer)
the full-sequence forward writes its K/V at positions [0, s) through the
cache's quantizer (``serve/kvq.py``), and :func:`attention_decode` writes
one position and attends the dequantized cache.  Both write IN PLACE.

The paged steps (decode, speculative verify, chunked prefill) project QKV
through the quantization ctx (``attn_qkv``), apply RoPE, quantize the new
K/V through the pool's page mode, scatter them into the slot's pages,
read every slot's key range through the page table with
``repro_torch.kernels.paged_attention`` and project the result
(``attn_out``).  Writes into the pool arrays happen IN PLACE (the pool
holds one copy of every page; the reference's functional ``.at[].set``
would copy the whole pool per write).  Positions that must not land in a
slot's pages (idle slots, chunk padding, prefix-shared positions) route to
the reserved scratch page 0, which is never read back for a live row.

Under tensor-parallel serving (an active ``serve_sharding.HeadShard``)
each rank keeps only its contiguous run of KV heads and their q heads
after the projection, writes and reads only its own pages, and merges the
heads back with the zero-pad all-reduce before ``attn_out``, which needs
the whole channel vector for its per-token activation quantization.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.models.common import ModelConfig, apply_rope, softcap
from repro_torch.parallel import serve_sharding as TP
from repro_torch.parallel.act_sharding import cache_update_mode
from repro_torch.serve import kvq

NEG_INF = -1e9

# Optional KV calibration hook: when set (``repro_torch.quantize`` installs
# a ``kvq.KVCalibCollector`` over the calibration forwards), every
# full-sequence ``attention`` reports its post-RoPE K/V.  None otherwise.
_KV_OBSERVER = None


def set_kv_observer(fn) -> None:
    """Install (or clear, with None) the calibration KV observer, called
    as ``fn(layer_prefix, k, v)`` with [b, s, kvh, dh] tensors."""
    global _KV_OBSERVER
    _KV_OBSERVER = fn


def _split_qkv(cfg: ModelConfig, qkv: torch.Tensor):
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = qkv.shape
    q = qkv[..., : h * dh].reshape(b, s, h, dh)
    k = qkv[..., h * dh: (h + kv) * dh].reshape(b, s, kv, dh)
    v = qkv[..., (h + kv) * dh:].reshape(b, s, kv, dh)
    return q, k, v


def _project_qkv(cfg, p, ctx, x, positions, shard=None):
    """QKV projection and RoPE; with a ``shard``, only this rank's heads
    (views of the projection) go on."""
    qkv = ctx("attn_qkv", x, p["wqkv"])
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].to(x.dtype)
    q, k, v = _split_qkv(cfg, qkv)
    if shard is not None:
        q, k, v = (TP.slice_heads(t, shard) for t in (q, k, v))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
         v: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query softmax(QK^T/sqrt(d) [softcap] + bias) V.  q
    [b, sq, h, dh]; k/v [b, sk, kv, dh] (unrepeated: the group dim rides
    inside the einsum)."""
    b, sq_, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq_, kv, g, dh)
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    scores = softcap(scores, cfg.attn_softcap)
    if bias is not None:
        scores = scores + bias[:, :, None]    # [..., sq, sk] -> group bcast
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq_, h, dh)


def causal_bias(sq: int, sk: int, window: int, window_flag: bool,
                device=None) -> torch.Tensor:
    """[1, 1, sq, sk] additive mask; ``window_flag`` selects sliding-window
    locality."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    allow = kpos <= qpos
    if window_flag:
        allow = allow & (kpos > qpos - window)
    return torch.where(allow, 0.0, NEG_INF).float()[None, None]


def attention(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor,
              positions: torch.Tensor, *, window_flag: bool = False,
              cache: Optional[dict] = None, causal: bool = True
              ) -> torch.Tensor:
    """Full-sequence attention (training, calibration, prefill), causal
    unless ``causal=False`` (the encoder).  x [b, s, d]; positions [b, s].
    Reports the post-RoPE K/V to the KV observer under the ctx's site
    prefix.  ``cache``: one layer's dense cache arrays ([b, s_max, kvh,
    dh], int8 caches with their scales), written in place at positions
    [0, s) through the cache's quantizer."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, ctx, x, positions)
    if _KV_OBSERVER is not None:
        _KV_OBSERVER(getattr(ctx, "prefix", ""), k, v)
    if cache is not None:
        for n, val in kvq.from_cache(cache).quantize(k, v).items():
            cache[n][:, :s] = val.to(cache[n].dtype)
    bias = (causal_bias(s, s, cfg.window_size, window_flag, device=x.device)
            if causal else None)
    o = sdpa(cfg, q, k, v, bias).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return ctx("attn_out", o, p["wo"])


def cross_attention(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor,
                    memory: torch.Tensor) -> torch.Tensor:
    """Whisper-style cross attention: queries from the decoder's x [b, s,
    d], keys and values projected from the encoder's memory [b, sm, d]
    (``cross_kv``, recomputed at every call, as the reference does); no
    mask, no RoPE."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ctx("cross_q", x, p["wq"]).reshape(b, s, h, dh)
    kvm = ctx("cross_kv", memory, p["wkv"])
    sm = memory.shape[1]
    k = kvm[..., : kv * dh].reshape(b, sm, kv, dh)
    v = kvm[..., kv * dh:].reshape(b, sm, kv, dh)
    o = sdpa(cfg, q, k, v, None).reshape(b, s, h * dh)
    return ctx("cross_out", o, p["wo"])


def attention_decode(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor,
                     cache: dict, *, window_flag: bool = False
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode against a dense cache.  x [b, 1, d]; ``cache``
    holds one layer's k/v [b, s_max, kvh, dh] (int8 caches add
    k/v_scale [b, s_max, kvh, 1]) and ``pos``, a 0-d int32 tensor.  The
    new K/V are quantized by the cache's mode and written at ``pos`` in
    place (an indexed copy, or under ``act_sharding``'s "select" mode an
    elementwise ``where(arange == pos)``, bit-equal); the whole cache is
    read back dequantized and attended with the causal (and, for a local
    layer, window) mask.  Returns (out, cache)."""
    b = x.shape[0]
    pos = cache["pos"]
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(cfg, p, ctx, x, positions)
    quantizer = kvq.from_cache(cache)
    parts = quantizer.quantize(k, v)
    if cache_update_mode() == "select":
        # elementwise write (local to a shard of a sequence-sharded cache)
        sel = (torch.arange(cache["k"].shape[1], device=x.device)
               == pos)[None, :, None, None]
        for n, val in parts.items():
            cache[n].copy_(torch.where(sel, val.to(cache[n].dtype), cache[n]))
    else:
        at = pos.reshape(1).long()
        for n, val in parts.items():
            cache[n].index_copy_(1, at, val.to(cache[n].dtype))
    kk, vv = quantizer.dequantize(cache, x.dtype)
    kpos = torch.arange(kk.shape[1], device=x.device)
    allow = kpos <= pos
    if window_flag:
        allow = allow & (kpos > pos - cfg.window_size)
    bias = torch.where(allow, 0.0, NEG_INF).float()[None, None, None, :]
    o = sdpa(cfg, q, kk, vv, bias).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return ctx("attn_out", o, p["wo"]), cache


def n_attn_layers(cfg: ModelConfig) -> int:
    """Number of KV-cache-bearing attention invocations in the stack (the
    hybrid's shared block: one a use, each with its own cache)."""
    if cfg.shared_attn_every:
        k = cfg.shared_attn_every
        return sum(1 for i in range(cfg.n_layers) if i % k == k - 1)
    return sum(1 for b in cfg.blocks if b in ("attn", "local", "global", "moe"))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda",
               layers: Optional[int] = None) -> dict:
    """Zero dense KV cache, stacked [L, b, s_max, kvh, dh] (L =
    ``layers``, else :func:`n_attn_layers`), and ``pos`` 0 (a 0-d int32
    tensor)."""
    n_attn = layers if layers is not None else n_attn_layers(cfg)
    shape = (n_attn, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _scatter(cache: dict, parts: dict, page_idx: torch.Tensor,
             offset: torch.Tensor) -> None:
    """In-place page write: parts[n] [b, s, kvh, *] -> cache[n][page, off]."""
    for n, val in parts.items():
        cache[n][page_idx, offset] = val.to(cache[n].dtype)


def _read(cfg, window_flag, q, cache, page_table, pos, quantizer, shard):
    """The paged read of this rank's heads, merged back to every head
    under a shard.  The kernel's split plan takes the global KV-head count,
    so each (slot, head) block sums in the same order at every tp."""
    win = cfg.window_size if window_flag else PA.NO_WINDOW
    o = PA.paged_attention_decode(
        q, cache["k"], cache["v"], page_table, pos, window=win,
        softcap=cfg.attn_softcap, plan_kv_heads=cfg.n_kv_heads,
        **quantizer.kernel_operands(cache))
    return o if shard is None else TP.all_heads(o, cfg.n_heads, shard)


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
    shard = TP.active()
    q, k, v = _project_qkv(cfg, p, ctx, x, pos[:, None], shard)
    quantizer = kvq.from_cache(cache)
    page_idx = torch.gather(page_table, 1, (pos // ps)[:, None].long())[:, 0]
    _scatter(cache, {n: t[:, 0] for n, t in quantizer.quantize(k, v).items()},
             page_idx.long(), (pos % ps).long())
    o = _read(cfg, window_flag, q[:, 0], cache, page_table, pos, quantizer,
              shard)
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
    shard = TP.active()
    q, k, v = _project_qkv(cfg, p, ctx, x, p_abs, shard)
    quantizer = kvq.from_cache(cache)
    writable = (p_abs >= w_lo[:, None]) & (p_abs < w_hi[:, None])
    logical = torch.clamp(p_abs // ps, 0, page_table.shape[1] - 1).long()
    page = torch.gather(page_table, 1, logical)
    page_idx = torch.where(writable, page, torch.zeros_like(page))
    _scatter(cache, quantizer.quantize(k, v), page_idx.long(),
             (p_abs % ps).long())
    o = _read(cfg, window_flag, q, cache, page_table, start, quantizer, shard)
    o = o.reshape(b, C, cfg.n_heads * cfg.head_dim)
    return ctx("attn_out", o, p["wo"]), cache


def attention_verify_paged(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor,
                           cache: dict, *, window_flag: bool = False
                           ) -> Tuple[torch.Tensor, dict]:
    """Pool-wide multi-token decode (the speculative verify step).  x
    [b, k, d]: per slot the last committed token then up to k - 1 draft
    tokens; ``cache`` holds one layer's pages plus ``page_table`` [b, P],
    ``pos`` [b] (the first row's position) and ``n_valid`` [b] int32 (real
    rows per slot; 0 parks a slot).  Row j of slot b sits at position
    ``pos[b] + j``.  All k rows' K/V are written first (rows at index >=
    ``n_valid`` route to scratch page 0), then one kernel call attends the
    whole ``[slot, k]`` block with a per-row causal mask.  Rejected rows
    need no undo: they are overwritten when the slot's position reaches
    them."""
    b, kb, _ = x.shape
    pos, n_valid = cache["pos"], cache["n_valid"]
    page_table = cache["page_table"]
    ps = cache["k"].shape[1]
    positions = pos[:, None] + torch.arange(kb, dtype=torch.int32,
                                            device=x.device)[None]   # [b, k]
    shard = TP.active()
    q, k, v = _project_qkv(cfg, p, ctx, x, positions, shard)
    quantizer = kvq.from_cache(cache)
    logical = torch.clamp(positions // ps, 0, page_table.shape[1] - 1).long()
    page = torch.gather(page_table, 1, logical)
    valid = (torch.arange(kb, device=x.device)[None] < n_valid[:, None])
    page_idx = torch.where(valid, page, torch.zeros_like(page))
    _scatter(cache, quantizer.quantize(k, v), page_idx.long(),
             (positions % ps).long())
    o = _read(cfg, window_flag, q, cache, page_table, pos, quantizer, shard)
    o = o.reshape(b, kb, cfg.n_heads * cfg.head_dim)
    return ctx("attn_out", o, p["wo"]), cache
