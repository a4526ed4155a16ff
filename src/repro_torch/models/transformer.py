"""The model stack of all five families: parameter init, the eager
full-sequence ``forward`` (training, calibration, prefill into a dense
cache), the LM loss, the dense-cache ``decode_step`` and the three paged
serving steps.

Counterpart of ``repro/models/transformer.py``.  Families
(``cfg.family``):

  dense   — attention (+ a per-layer window flag) + MLP
  moe     — attention + mixture-of-experts FFN
  ssm     — Mamba2 blocks only (``models/ssm.py``)
  hybrid  — Mamba2 blocks + ONE shared attention + MLP block applied
            after every ``shared_attn_every``-th (zamba2); each use has
            its own KV cache and its own sites ``shared{j}/``
  encdec  — a bidirectional encoder over precomputed frames, then a
            decoder with cross attention to its memory (whisper)

The reference scans over ``[L, ...]``-stacked layers; here the layer
loop is a Python loop over per-layer param dicts (``repro_torch.convert``
maps the reference's stacked tree), and sites carry eager names
(``layer{i}/...``, ``enc{i}/...``, ``shared{j}/...``) so a ``QuantCtx``
finds each site's packed kernel buffers and a ``CollectCtx`` attributes
calibration stats per site.  ``decode_step`` names its sites the same
way; the reference's hybrid decode calls the shared block unnamed and
without its buffers, so a fused zamba2 artifact decodes here where the
reference raises.  ``cfg.remat`` recomputes each layer's activations in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scan body.  The reference's ``scan=`` and
``qparams=`` arguments have no counterpart: there is no scan, and
per-site quantization data comes from the ctx.  The paged serving steps
run the dense and MoE families only, as in the reference.
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
from repro_torch.models import ssm as S
from repro_torch.models.common import (ModelConfig, apply_norm,
                                       cross_entropy, dense_init, softcap)
from repro_torch.parallel import serve_sharding as TP
from repro_torch.parallel.act_sharding import constrain


class _Named:
    """Prefixes site names (``layer{i}/``, ``enc{i}/``, ``shared{j}/``)."""

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


def _init_attention(gen, cfg, device, cross: bool = False) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if cross:
        return {"wq": dense_init(gen, (d, h * dh), d, device),
                "wkv": dense_init(gen, (d, 2 * kv * dh), d, device),
                "wo": dense_init(gen, (h * dh, d), h * dh, device)}
    attn = {"wqkv": dense_init(gen, (d, (h + 2 * kv) * dh), d, device),
            "wo": dense_init(gen, (h * dh, d), h * dh, device)}
    if cfg.qkv_bias:
        attn["bqkv"] = torch.zeros((h + 2 * kv) * dh, device=device)
    return attn


def _init_layer(gen, cfg, kind: str, device, decoder: bool = False) -> dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"ln1": _norm(cfg, d, device),
                "ssm": S.init_ssm(gen, cfg, device)}
    layer = {"ln1": _norm(cfg, d, device),
             "attn": _init_attention(gen, cfg, device),
             "ln2": _norm(cfg, d, device)}
    if kind == "moe":
        layer["moe"] = E.init_moe(gen, cfg, device)
    else:
        layer["mlp"] = M.init_mlp(gen, cfg, device)
    if cfg.sandwich_norm:
        layer["ln1b"] = _norm(cfg, d, device)
        layer["ln2b"] = _norm(cfg, d, device)
    if decoder:
        layer["cross"] = _init_attention(gen, cfg, device, cross=True)
        layer["ln3"] = _norm(cfg, d, device)
    return layer


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from ``seed``, in the port's layout: ``layers`` a
    list of per-layer dicts (sandwich norms ``ln1b``/``ln2b`` where
    ``cfg.sandwich_norm`` is set; a ``moe`` subtree in place of ``mlp``
    for a ``moe`` block; ``ln1`` + ``ssm`` for a ``mamba`` block;
    ``cross`` + ``ln3`` in a decoder layer), ``shared`` the hybrid's one
    shared attention + MLP block, ``enc_layers`` + ``enc_ln_f`` the
    encoder, and an ``lm_head`` [d, V_pad] for an untied head.
    ``torch.Generator`` streams differ from ``jax.random``: tests that
    compare with the reference pass its params through
    ``repro_torch.convert.from_jax_params`` instead.  On the ``meta``
    device the tree holds shapes and dtypes only (no generator there)."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": 0.02 * torch.randn((cfg.padded_vocab, d), generator=gen,
                                    device=device),
        "ln_f": _norm(cfg, d, device),
    }
    fam = cfg.family
    if fam == "encdec":
        params["enc_layers"] = [_init_layer(gen, cfg, "attn", device)
                                for _ in range(cfg.n_enc_layers)]
        params["enc_ln_f"] = _norm(cfg, d, device)
        params["layers"] = [_init_layer(gen, cfg, "attn", device, decoder=True)
                            for _ in range(cfg.n_layers)]
    elif fam == "hybrid":
        params["layers"] = [_init_layer(gen, cfg, "mamba", device)
                            for _ in range(cfg.n_layers)]
        params["shared"] = _init_layer(gen, cfg, "attn", device)
    else:
        params["layers"] = [_init_layer(gen, cfg, kind, device)
                            for kind in cfg.blocks]
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
    x = constrain(x)
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


# the arrays of a cache that are not per-layer K/V
_SSM_KEYS = ("conv_x", "conv_bc", "ssm")
_NOT_KV = ("pos", "memory") + _SSM_KEYS


def _kv_arrays(cache) -> dict:
    return {n: a for n, a in cache.items() if n not in _NOT_KV}


def _layer_call(cfg, fn, x):
    """``fn(x)``, its activations recomputed in the backward pass when
    ``cfg.remat`` is set and autograd records."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _mamba_block(cfg, lp, ctx, x, want_state=False):
    x = constrain(x)
    h = apply_norm(cfg, lp["ln1"], x)
    o, st = S.ssm_block(cfg, lp["ssm"], ctx, h, want_state=want_state)
    return x + o, st


def _decoder_block(cfg, lp, ctx, x, memory, attend):
    """Whisper decoder layer: self attention (``attend(p, ctx, h)``),
    cross attention to ``memory``, MLP.  The attention runs under an
    empty-prefix wrapper of the layer's ctx, as the reference's
    ``_decoder_block``: site names keep ``layer{i}/``, while the KV
    observer sees the prefix "" for every decoder layer."""
    nctx = _Named(ctx, "")
    x = constrain(x)
    h = apply_norm(cfg, lp["ln1"], x)
    x = x + attend(lp["attn"], nctx, h)
    h = apply_norm(cfg, lp["ln3"], x)
    x = x + A.cross_attention(cfg, lp["cross"], nctx, h, memory)
    h = apply_norm(cfg, lp["ln2"], x)
    return x + M.mlp(cfg, lp["mlp"], nctx, h)


def _write_state(cache, i, st) -> None:
    for n in _SSM_KEYS:
        cache[n][i] = st[n].to(cache[n].dtype)


def _is_shared_slot(cfg, i) -> bool:
    """The hybrid's shared block runs after mamba layer ``i``."""
    k = cfg.shared_attn_every
    return i % k == k - 1


def _run_dense(cfg, params, x, positions, ctx, kv, train):
    aux_total = torch.zeros((), device=x.device)
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.blocks)):
        c_i = None if kv is None else _layer_caches(kv, i)
        attend = (lambda p, c, h, flag=kind == "local", c_i=c_i:
                  A.attention(cfg, p, c, h, positions, window_flag=flag,
                              cache=c_i))
        layer = functools.partial(_block, cfg, lp, _Named(ctx, f"layer{i}/"),
                                  attend=attend, train=train)
        x, aux = _layer_call(cfg, layer, x)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _run_ssm(cfg, params, x, positions, ctx, cache):
    """Mamba stack (and, for the hybrid, the shared block after every
    ``shared_attn_every``-th layer, the j-th use named ``shared{j}/`` and
    writing KV cache j).  The final conv and SSD states go into ``cache``
    in place."""
    kv = None if cache is None else _kv_arrays(cache)
    j = 0
    for i, lp in enumerate(params["layers"]):
        layer = functools.partial(_mamba_block, cfg, lp,
                                  _Named(ctx, f"layer{i}/"),
                                  want_state=cache is not None)
        x, st = _layer_call(cfg, layer, x)
        if st is not None:
            _write_state(cache, i, st)
        if cfg.family == "hybrid" and _is_shared_slot(cfg, i):
            c_j = None if kv is None else _layer_caches(kv, j)
            attend = (lambda p, c, h, c_j=c_j:
                      A.attention(cfg, p, c, h, positions, cache=c_j))
            block = functools.partial(_block, cfg, params["shared"],
                                      _Named(ctx, f"shared{j}/"),
                                      attend=attend)
            x, _ = _layer_call(cfg, block, x)
            j += 1
    return x


def _encode(cfg, params, frames, ctx):
    """Whisper encoder over precomputed frame embeddings (the conv
    frontend is a stub, as in the reference): bidirectional attention
    layers named ``enc{i}/``, then ``enc_ln_f``."""
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    x = frames
    for i, lp in enumerate(params["enc_layers"]):
        attend = (lambda p, c, h:
                  A.attention(cfg, p, c, h, positions, causal=False))
        layer = functools.partial(_block, cfg, lp, _Named(ctx, f"enc{i}/"),
                                  attend=attend)
        x, _ = _layer_call(cfg, layer, x)
    return apply_norm(cfg, params["enc_ln_f"], x)


def _run_decoder(cfg, params, x, positions, memory, ctx, kv):
    for i, lp in enumerate(params["layers"]):
        c_i = None if kv is None else _layer_caches(kv, i)
        attend = (lambda p, c, h, c_i=c_i:
                  A.attention(cfg, p, c, h, positions, cache=c_i))
        layer = functools.partial(_decoder_block, cfg, lp,
                                  _Named(ctx, f"layer{i}/"), memory=memory,
                                  attend=attend)
        x = _layer_call(cfg, layer, x)
    return x


def forward(cfg: ModelConfig, params, tokens, ctx=None, *, extra=None,
            train: bool = False, cache=None) -> dict:
    """Full-sequence eager forward of every family (the reference's
    ``forward(..., scan=False)``): sites carry eager names, so a
    ``CollectCtx`` attributes calibration stats per site, and each
    attention reports its K/V to the KV observer.  tokens [b, s];
    ``extra={"patches": [b, n_patches, d]}`` prefixes a VLM's patch
    embeddings (``cfg.n_patches``); an encoder-decoder needs
    ``extra={"frames": [b, n_frames, d]}``.  ``train=True`` selects the
    MoE capacity-factor dispatch (the inference default is dropless).
    ``cache`` receives the prefill in place: every attention layer's K/V
    at positions [0, s') (``attention.init_cache`` or
    ``kvcache.init_int8_cache``), every mamba layer's final conv and SSD
    state (``ssm.init_ssm_state``); an encoder-decoder's returned cache
    also carries the encoder output as ``memory``.  Returns {"logits":
    [b, s', V], "aux": the summed MoE aux loss (0 elsewhere), "cache":
    the cache with ``pos`` s', or None}, s' = s plus the patches."""
    ctx = ctx or FpCtx()
    fam = cfg.family
    x = _embed(cfg, params, tokens, extra)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), device=x.device)
    kv = None if cache is None else _kv_arrays(cache)
    new_cache = None if cache is None else dict(cache)
    if fam == "encdec":
        memory = _encode(cfg, params, extra["frames"].to(x.dtype), ctx)
        x = _run_decoder(cfg, params, x, positions, memory, ctx, kv)
        if new_cache is not None:
            new_cache["memory"] = memory
    elif fam in ("ssm", "hybrid"):
        x = _run_ssm(cfg, params, x, positions, ctx, cache)
    else:
        x, aux_total = _run_dense(cfg, params, x, positions, ctx, kv, train)
    if new_cache is not None:
        new_cache["pos"] = torch.full((), s, dtype=torch.int32,
                                      device=x.device)
    return {"logits": _head(cfg, params, x), "aux": aux_total,
            "cache": new_cache}


def lm_loss(cfg: ModelConfig, params, batch, ctx=None, *,
            aux_weight: float = 0.01, train: bool = True):
    """The trainer's loss: batch {"tokens": [b, s], "labels": [b, s],
    optional "mask", "patches", "frames"} (tensors on the params' device)
    -> (CE + aux_weight x MoE aux, {"ce", "aux"}).  ``train`` (default
    True) selects the capacity-factor MoE dispatch; a VLM's loss runs over
    the text positions only."""
    extra = {k: batch[k] for k in ("patches", "frames") if k in batch}
    out = forward(cfg, params, batch["tokens"], ctx, extra=extra or None,
                  train=train)
    logits = out["logits"]
    if cfg.n_patches and "patches" in batch:
        logits = logits[:, -batch["tokens"].shape[1]:]
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_size,
                         batch.get("mask"))
    return loss + aux_weight * out["aux"], {"ce": loss, "aux": out["aux"]}


def decode_step(cfg: ModelConfig, params, tokens, cache, ctx=None
                ) -> Tuple[torch.Tensor, dict]:
    """One token against a dense cache (from ``forward(..., cache=...)``
    or zeros), for every family.  tokens [b, 1] -> (logits [b, 1, V], the
    cache with ``pos`` + 1); the cache arrays (K/V, conv and SSD states)
    are written in place.  Sites carry the forward's names, the hybrid's
    shared block ``shared{j}/`` included; an encoder-decoder attends the
    cache's ``memory`` (its cross K/V projected again at every step, as
    in the reference)."""
    fam = cfg.family
    pos = cache["pos"]
    kv = _kv_arrays(cache)
    x = _embed(cfg, params, tokens)
    if fam in ("dense", "moe"):
        logits = _run(cfg, params, x, kv, {"pos": pos}, ctx,
                      A.attention_decode)
        return logits, {**cache, "pos": pos + 1}
    ctx = ctx or FpCtx()

    def attend_at(c):
        return lambda p, c_, h: A.attention_decode(cfg, p, c_, h,
                                                   {**c, "pos": pos})[0]
    if fam == "encdec":
        for i, lp in enumerate(params["layers"]):
            x = _decoder_block(cfg, lp, _Named(ctx, f"layer{i}/"), x,
                               cache["memory"],
                               attend_at(_layer_caches(kv, i)))
    else:
        j = 0
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(cfg, lp["ln1"], x)
            o, st = S.ssm_decode(cfg, lp["ssm"], _Named(ctx, f"layer{i}/"),
                                 h, {n: cache[n][i] for n in _SSM_KEYS})
            x = x + o
            _write_state(cache, i, st)
            if fam == "hybrid" and _is_shared_slot(cfg, i):
                x, _ = _block(cfg, params["shared"],
                              _Named(ctx, f"shared{j}/"), x,
                              attend_at(_layer_caches(kv, j)))
                j += 1
    return _head(cfg, params, x), {**cache, "pos": pos + 1}


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
