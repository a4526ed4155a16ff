"""Train / eval / prefill / serve step builders — counterpart of
``repro/launch/steps.py``.

``quant`` is anything ``core.context.as_ctx`` takes: None (fp), a
``QuantConfig``, a ``SitePolicy`` or a ``repro_torch.quantize.
QuantArtifact``.  A fused artifact (``MUXQ_FUSED_SERVE``) puts every site
through ``kernels.dispatch`` onto ``rowwise_quantize`` + ``muxq_gemm``,
on the card or, for CPU tensors, their plain versions.  Batches are dicts
of tensors on ``device``.

The steps run every family.  The prefill builds the cache the
reference builds: a KV cache for the dense, MoE and encoder-decoder
families (the latter's prefill adds the encoder's ``memory``), the
stacked conv and SSD states for the SSM family, and both for the hybrid
(one KV cache a use of its shared block).  ``frames`` and
``patches`` in a batch pass to the forward.

The reference's ``scan=`` and ``qparams=`` have no counterpart here (no
scan; per-layer quantization data lives in the ctx), and nothing is
jitted: each step runs eagerly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.context import as_ctx
from repro_torch.core.muxq import QuantConfig
from repro_torch.models import transformer as T
from repro_torch.models.attention import init_cache
from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import init_ssm_state
from repro_torch.optim import adamw
from repro_torch.serve.kvcache import init_int8_cache


def _extra(batch) -> Optional[dict]:
    return {k: batch[k] for k in ("patches", "frames") if k in batch} or None


def _prefill_cache(cfg: ModelConfig, b: int, s_max: int, kv_dtype,
                   device) -> dict:
    """The empty cache a family's prefill fills (``pos`` 0)."""
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        cache.update(init_ssm_state(cfg, b, cfg.n_layers, device=device))
    if cfg.family != "ssm":
        if kv_dtype == torch.int8:
            cache.update(init_int8_cache(cfg, b, s_max, device=device))
        else:
            cache.update(init_cache(cfg, b, s_max, dtype=kv_dtype,
                                    device=device))
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def make_train_step(cfg: ModelConfig,
                    acfg: Optional[adamw.AdamWConfig] = None, quant=None,
                    cast_bf16: bool = False, device="cuda"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``lm_loss``, its gradients by autograd, then one AdamW
    step.  Metrics: loss, ce, aux, lr, grad_norm (0-d tensors).
    ``cast_bf16`` runs the forward on bf16 copies of the f32 params (the
    gradients flow back through the cast to the f32 masters)."""
    acfg = acfg or adamw.AdamWConfig()
    ctx = as_ctx(quant, device)

    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(cfg, params, batch, ctx,
                                            cast_bf16)
        new_params, new_state, metrics = adamw.apply_updates(
            acfg, params, grads, opt_state)
        metrics.update(loss=loss.detach(), ce=parts["ce"].detach(),
                       aux=parts["aux"].detach())
        return new_params, new_state, metrics

    return train_step


def loss_and_grads(cfg: ModelConfig, params, batch, ctx,
                   cast_bf16: bool = False):
    """The train step's forward and backward: (``lm_loss``, its parts, the
    gradients as a tree shaped like ``params``; an unused leaf's is
    zeros)."""
    leaves = [t.detach().requires_grad_(True)
              for t in adamw.tree_leaves(params)]
    p = adamw.tree_unflatten(params, leaves)
    if cast_bf16:
        p = adamw.tree_map(lambda x: x.to(torch.bfloat16)
                           if x.dtype == torch.float32 else x, p)
    loss, parts = T.lm_loss(cfg, p, batch, ctx=ctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss, parts, adamw.tree_unflatten(params, grads)


def make_eval_step(cfg: ModelConfig, quant=None, device="cuda"):
    """``eval_step(params, batch) -> ce``: ``lm_loss``'s cross-entropy
    (with its default ``train=True`` dispatch, as the reference's), no
    autograd."""
    ctx = as_ctx(quant, device)

    def eval_step(params, batch):
        with torch.no_grad():
            _, parts = T.lm_loss(cfg, params, batch, ctx=ctx)
        return parts["ce"]

    return eval_step


def make_prefill_step(cfg: ModelConfig, seq_len: int, quant=None,
                      kv_dtype=torch.bfloat16, device="cuda"):
    """Full-sequence prefill: ``prefill_step(params, batch) -> (first
    sampled token [b] int32, the cache)``.  A KV cache holds ``seq_len``
    plus the patches; ``kv_dtype=torch.int8`` builds an int8 one
    (``kvcache.init_int8_cache``), any float dtype an fp one.  An
    encoder-decoder's batch carries ``frames`` [b, n_frames, d]."""
    ctx = as_ctx(quant, device)
    s_max = seq_len + cfg.n_patches

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = _prefill_cache(cfg, tokens.shape[0], s_max, kv_dtype,
                               tokens.device)
        with torch.no_grad():
            out = T.forward(cfg, params, tokens, ctx, extra=_extra(batch),
                            cache=cache)
        next_tok = torch.argmax(out["logits"][:, -1, : cfg.vocab_size], -1)
        return next_tok.to(torch.int32), out["cache"]

    return prefill_step


def make_serve_step(cfg: ModelConfig, quant=None, device="cuda"):
    """One-token decode against the dense cache: ``serve_step(params,
    {"tokens": [b, 1], "cache": ...}) -> (next token [b] int32, cache)``."""
    ctx = as_ctx(quant, device)

    def serve_step(params, batch):
        with torch.no_grad():
            logits, cache = T.decode_step(cfg, params, batch["tokens"],
                                          batch["cache"], ctx)
        next_tok = torch.argmax(logits[:, -1, : cfg.vocab_size], -1)
        return next_tok.to(torch.int32), cache

    return serve_step


MUXQ_SERVE = QuantConfig(method="muxq", real_int8=True, muxq_form="fused",
                         outlier_mode="static", act_granularity="per_token",
                         weight_granularity="per_channel", exp_factor=2)

# the same math through the packed single-GEMM kernel path
# (kernels.dispatch): the Hopper kernels on the card, their plain versions
# on CPU tensors.  Needs an artifact built by quantize_model.
MUXQ_FUSED_SERVE = MUXQ_SERVE.replace(backend="fused")
