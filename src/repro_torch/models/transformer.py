"""The decoder stack of the dense and MoE families: parameter init, the
eager full-sequence ``forward`` (training, calibration, prefill into a
dense cache), the LM loss, the dense-cache ``decode_step`` and the three
paged serving steps.

Counterpart of the dense and MoE families of
``repro/models/transformer.py``.  The reference scans over
``[L, ...]``-stacked layers; here the layer loop is a Python loop over
per-layer param dicts (``repro_torch.convert`` maps the reference's
stacked tree), and sites carry eager names (``layer{i}/...``) so a
``QuantCtx`` finds each layer's packed kernel buffers and a
``CollectCtx`` attributes calibration stats per layer.  A layer with a
``"moe"`` subtree runs the mixture-of-experts block (``models/moe.py``)
where a dense layer runs its MLP.  ``cfg.remat`` recomputes each layer's
activations in the backward pass (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` of its scan body.  The reference's
``scan=`` and ``qparams=`` arguments have no counterpart: there is no
scan, and per-layer quantization data comes from the ctx.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.context import FpCtx
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as E
from repro_torch.models.common import (ModelConfig, apply_norm,
                                       cross_entropy, dense_init, softcap)
from repro_torch.parallel import serve_sharding as TP


class _Named:
    """Prefixes site names with ``layer{i}/``."""

    def __init__(self, ctx, prefix: str):
        self.ctx, self.prefix = ctx, prefix

    def __call__(self, name, x, w):
        return self.ctx(self.prefix + name, x, w)

    def emm(self, name, x, w):
        return self.ctx.emm(self.prefix + name, x, w)


# ---------------------------------------------------------------------------
# Init (seeded random weights, the reference's shapes and scales)
# ---------------------------------------------------------------------------

def _norm(cfg, d, device):
    if cfg.norm == "rmsnorm":
        return {"gain": torch.zeros(d, device=device)}
    return {"gain": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from ``seed``, in the port's layout, for the dense
    and MoE families: sandwich norms (``ln1b``/``ln2b``) where
    ``cfg.sandwich_norm`` is set, a ``moe`` subtree (router, per-expert
    ``wi``/``wo``, the shared expert) in place of ``mlp`` for a ``moe``
    block, and an ``lm_head`` [d, V_pad] for an untied head.
    ``torch.Generator`` streams differ from ``jax.random``: tests that
    compare with the reference pass its params through
    ``repro_torch.convert.from_jax_params`` instead."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError("the port initializes the dense and MoE "
                                  f"decoders, not {cfg.family}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, dh = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    params = {
        "embed": 0.02 * torch.randn((cfg.padded_vocab, d), generator=gen,
                                    device=device),
        "ln_f": _norm(cfg, d, device),
        "layers": [],
    }
    for kind in cfg.blocks:
        attn = {"wqkv": dense_init(gen, (d, (h + 2 * kv) * dh), d, device),
                "wo": dense_init(gen, (h * dh, d), h * dh, device)}
        if cfg.qkv_bias:
            attn["bqkv"] = torch.zeros((h + 2 * kv) * dh, device=device)
        layer = {"ln1": _norm(cfg, d, device), "attn": attn,
                 "ln2": _norm(cfg, d, device)}
        if kind == "moe":
            layer["moe"] = E.init_moe(gen, cfg, device)
        else:
            layer["mlp"] = M.init_mlp(gen, cfg, device)
        if cfg.sandwich_norm:
            layer["ln1b"] = _norm(cfg, d, device)
            layer["ln2b"] = _norm(cfg, d, device)
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.padded_vocab), d, device)
    return params


# ---------------------------------------------------------------------------
# Paged serving steps
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens, extra=None) -> torch.Tensor:
    """Token embeddings; with ``cfg.n_patches`` and ``extra["patches"]``
    [b, n_patches, d] the patch embeddings come first (the VLM prefix)."""
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    if cfg.n_patches and extra is not None and "patches" in extra:
        x = torch.cat([extra["patches"].to(x.dtype), x], dim=1)
    return x


def _layer_caches(kv: dict, i: int):
    return {n: a[i] for n, a in kv.items()}


def _block(cfg, lp, ctx, x, attend, train: bool = False):
    """One pre-norm layer; ``attend(p, ctx, h)`` is the attention flavour;
    ``train`` selects the MoE block's capacity-factor dispatch.  Returns
    (x, the MoE aux loss, or None for a dense layer)."""
    h = apply_norm(cfg, lp["ln1"], x)
    a = attend(lp["attn"], ctx, h)
    if cfg.sandwich_norm:
        a = apply_norm(cfg, lp["ln1b"], a)
    x = x + a
    h = apply_norm(cfg, lp["ln2"], x)
    if "moe" in lp:
        m, aux = E.moe(cfg, lp["moe"], ctx, h, train=train)
    else:
        m, aux = M.mlp(cfg, lp["mlp"], ctx, h), None
    if cfg.sandwich_norm:
        m = apply_norm(cfg, lp["ln2b"], m)
    return x + m, aux


def _head(cfg, params, x):
    """Final norm, the LM head (the embedding's transpose when tied, else
    ``params["lm_head"]`` [d, V_pad]; split by vocabulary columns under
    tensor-parallel serving) and the final softcap."""
    x = apply_norm(cfg, params["ln_f"], x)
    if cfg.tie_embeddings:
        head = params["embed"].T
    elif "lm_head" in params:
        head = params["lm_head"]
    else:
        raise ValueError(f"{cfg.name} has an untied LM head, but its params "
                         "carry no 'lm_head'")
    logits = TP.tp_logits(x, head.to(x.dtype))
    return softcap(logits, cfg.final_softcap)


def _run(cfg, params, x, kv, routing, ctx, step):
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"paged serving supports the dense and MoE "
                         f"families, not {cfg.family}")
    ctx = ctx or FpCtx()
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.blocks)):
        cache = {**_layer_caches(kv, i), **routing}
        attend = (lambda p, c, h, cache=cache, flag=kind == "local":
                  step(cfg, p, c, h, cache, window_flag=flag)[0])
        x, _ = _block(cfg, lp, _Named(ctx, f"layer{i}/"), x, attend)
    return _head(cfg, params, x)


def forward(cfg: ModelConfig, params, tokens, ctx=None, *, extra=None,
            train: bool = False, cache=None) -> dict:
    """Full-sequence eager forward of the dense and MoE families (the
    reference's ``forward(..., scan=False)``): sites carry ``layer{i}/``
    names, so a ``CollectCtx`` attributes calibration stats per layer, and
    each layer's attention reports its K/V to the KV observer.  tokens
    [b, s]; ``extra={"patches": [b, n_patches, d]}`` prefixes a VLM's
    patch embeddings (``cfg.n_patches``).  ``train=True`` selects the MoE
    capacity-factor dispatch (the inference default is dropless).
    ``cache`` (``attention.init_cache`` or ``kvcache.init_int8_cache``)
    receives every layer's K/V at positions [0, s') in place (prefill).
    Returns {"logits": [b, s', V], "aux": the summed MoE aux loss (0 for
    dense), "cache": the cache with ``pos`` s', or None}, s' = s plus the
    patches."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"the port's forward runs the dense and MoE "
                         f"families, not {cfg.family}")
    ctx = ctx or FpCtx()
    x = _embed(cfg, params, tokens, extra)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), device=x.device)
    kv = None if cache is None else {n: a for n, a in cache.items()
                                     if n != "pos"}
    remat = cfg.remat and torch.is_grad_enabled()
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.blocks)):
        c_i = None if kv is None else _layer_caches(kv, i)
        attend = (lambda p, c, h, flag=kind == "local", c_i=c_i:
                  A.attention(cfg, p, c, h, positions, window_flag=flag,
                              cache=c_i))
        layer = functools.partial(_block, cfg, lp, _Named(ctx, f"layer{i}/"),
                                  attend=attend, train=train)
        if remat:
            x, aux = checkpoint(layer, x, use_reentrant=False)
        else:
            x, aux = layer(x)
        if aux is not None:
            aux_total = aux_total + aux
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "pos": torch.full((), s, dtype=torch.int32,
                                                device=x.device)}
    return {"logits": _head(cfg, params, x), "aux": aux_total,
            "cache": new_cache}


def lm_loss(cfg: ModelConfig, params, batch, ctx=None, *,
            aux_weight: float = 0.01, train: bool = True):
    """The trainer's loss: batch {"tokens": [b, s], "labels": [b, s],
    optional "mask", "patches"} (tensors on the params' device) ->
    (CE + aux_weight x MoE aux, {"ce", "aux"}).  ``train`` (default True)
    selects the capacity-factor MoE dispatch; a VLM's loss runs over the
    text positions only."""
    extra = {"patches": batch["patches"]} if "patches" in batch else None
    out = forward(cfg, params, batch["tokens"], ctx, extra=extra, train=train)
    logits = out["logits"]
    if cfg.n_patches and "patches" in batch:
        logits = logits[:, -batch["tokens"].shape[1]:]
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_size,
                         batch.get("mask"))
    return loss + aux_weight * out["aux"], {"ce": loss, "aux": out["aux"]}


def decode_step(cfg: ModelConfig, params, tokens, cache, ctx=None
                ) -> Tuple[torch.Tensor, dict]:
    """One token against a dense cache (from ``forward(..., cache=...)``
    or zeros) for the dense and MoE families.  tokens [b, 1] -> (logits
    [b, 1, V], the cache with ``pos`` + 1); the cache arrays are written
    in place."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"the port's decode_step runs the dense and MoE "
                         f"families, not {cfg.family}")
    pos = cache["pos"]
    kv = {n: a for n, a in cache.items() if n != "pos"}
    logits = _run(cfg, params, _embed(cfg, params, tokens), kv,
                  {"pos": pos}, ctx, A.attention_decode)
    return logits, {**cache, "pos": pos + 1}


def decode_step_paged(cfg: ModelConfig, params, tokens, kv: dict,
                      page_table, pos, ctx=None) -> Tuple[torch.Tensor, dict]:
    """One-token decode for the whole slot pool against the paged KV pool.

    tokens [b, 1]; ``kv`` = {"k"/"v": [L, n_pages, ps, kvh, dh]} (int8 pages
    add "k_scale"/"v_scale" [L, n_pages, ps, kvh, 1]); ``page_table``
    [b, budget] int32 (its width is the read budget); ``pos`` [b] int32.
    Returns (logits [b, 1, V], kv) — the pool arrays are updated in place."""
    x = _embed(cfg, params, tokens)
    logits = _run(cfg, params, x, kv, {"page_table": page_table, "pos": pos},
                  ctx, A.attention_decode_paged)
    return logits, kv


def decode_verify_paged(cfg: ModelConfig, params, tokens, kv: dict,
                        page_table, pos, n_valid, ctx=None
                        ) -> Tuple[torch.Tensor, dict]:
    """Speculative verify: score a ``[slot, k]`` block of draft tokens for
    the whole pool in one call.  tokens [b, k] (per slot, the last
    committed token then up to k - 1 drafts; rows past ``n_valid[b]`` are
    padding); ``kv`` / ``page_table`` / ``pos`` as in
    :func:`decode_step_paged`, ``pos`` the first row's position; ``n_valid``
    [b] int32.  Returns (logits [b, k, V], kv): ``logits[b, j]`` is the
    next-token distribution after ``tokens[b, :j+1]``."""
    x = _embed(cfg, params, tokens)
    routing = {"page_table": page_table, "pos": pos, "n_valid": n_valid}
    logits = _run(cfg, params, x, kv, routing, ctx, A.attention_verify_paged)
    return logits, kv


def prefill_chunk_paged(cfg: ModelConfig, params, tokens, kv: dict,
                        page_table, start, write_lo, write_hi, ctx=None
                        ) -> Tuple[torch.Tensor, dict]:
    """One chunk per prefilling slot, several slots at once, straight into
    the paged pool.  tokens [b, C]; ``page_table`` [b, pages] int32;
    ``start`` / ``write_lo`` / ``write_hi`` [b] int32 (see
    ``attention.attention_prefill_paged``).  Returns (logits [b, C, V],
    kv), the pool arrays updated in place."""
    x = _embed(cfg, params, tokens)
    routing = {"page_table": page_table, "start": start,
               "write_lo": write_lo, "write_hi": write_hi}
    logits = _run(cfg, params, x, kv, routing, ctx, A.attention_prefill_paged)
    return logits, kv
