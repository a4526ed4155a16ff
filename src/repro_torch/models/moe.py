"""Mixture-of-Experts block (llama4-scout 16e top-1 + shared expert, dbrx
16e top-4) with group-local dispatch, for inference — counterpart of
``repro/models/moe.py``.

  * Tokens are routed within groups, each with its own capacity: one flat
    group at decode (s == 1), the batch rows above that (verify blocks and
    prefill chunks).  Inference is dropless: the capacity is the group's
    token count padded to 8, so a token goes through exactly the experts
    it picked and a decode step reproduces ``forward``.
  * The router runs in f32: softmax, top-k (ties to the lower expert
    index, as ``jax.lax.top_k``), the gates renormalized with the sum
    floored at 1e-9.  Assignments sort stably by expert; a token's slot
    in its expert comes from the counts' cumulative sum.
  * The dispatch buffer is [g, e, C, d]; at the expert matmuls the groups
    fold into each expert's token dimension ([e, g*C, d]), which runs
    through the quantization ctx (``ctx.emm``), so MUXQ applies per
    expert.  The combine sums each token's k weighted expert outputs in
    one fixed order (by expert), so it is deterministic on every device.
  * The shared expert (llama4) is a dense MLP on every token, through
    ``mlp()`` (eager sites ``layer{i}/mlp_up|down``).
  * The Switch aux load-balance loss comes back beside the output.

Not here: the trainer's capacity-factor dispatch (the reference's
``train=True``: capacity 1.25 x top_k x tokens / experts, over-capacity
tokens dropped) and ``set_expert_sharding`` (the expert-parallel sharding
constraint on the dispatch buffer); they join with the training and
sharding slices.  ``_dispatch_group`` keeps the reference's drop mask,
so a capacity under the group's token count drops as there.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.mlp import init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Seeded weights, the reference's shapes and scales (its ``wi`` takes
    ``dense_init``'s default fan-in, the expert count)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (d, e), d, device),
         "wi": dense_init(gen, (e, d, 2 * f), None, device),
         "wo": dense_init(gen, (e, f, d), f, device)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, cfg, device)
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert slot count for one dispatch group, the reference's
    dropless sizing (its ``factor=None``): top-k picks distinct experts,
    so ``n_tokens`` slots never overflow; padded to 8."""
    return max(8, ((n_tokens + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(cfg: ModelConfig, xf: torch.Tensor, probs: torch.Tensor,
                    cap: int):
    """Group-local dispatch.  xf [..., t, d], probs [..., t, e] (leading
    dims: independent groups) -> (buf [..., e*cap, d], slot [..., t*k],
    st [..., t*k], gates [..., t*k], keep [..., t*k]), the assignments in
    expert order."""
    *lead, t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    g = math.prod(lead)
    dev = xf.device
    gate_vals, expert_idx = _top_k(probs.reshape(g, t, e), k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    flat_expert = expert_idx.reshape(g, t * k)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k).expand(g, -1)
    order = torch.sort(flat_expert, dim=-1, stable=True).indices
    se = torch.gather(flat_expert, 1, order)
    st = torch.gather(flat_token, 1, order)
    sg = torch.gather(gate_vals.reshape(g, t * k), 1, order)

    counts = torch.zeros(g, e, dtype=torch.long, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, -1) - counts
    pos = torch.arange(t * k, device=dev) - torch.gather(starts, 1, se)
    keep = pos < cap
    slot = se * cap + torch.where(keep, pos, 0)
    # dropped assignments land on one sink row per group, then cut away
    rows = (torch.where(keep, slot, e * cap)
            + torch.arange(g, device=dev)[:, None] * (e * cap + 1))
    src = torch.gather(xf.reshape(g, t, d), 1, st[..., None].expand(-1, -1, d))
    buf = xf.new_zeros(g * (e * cap + 1), d)
    buf[rows.reshape(-1)] = src.reshape(-1, d)
    buf = buf.reshape(g, e * cap + 1, d)[:, : e * cap]
    return (buf.reshape(*lead, e * cap, d), slot.reshape(*lead, t * k),
            st.reshape(*lead, t * k), sg.reshape(*lead, t * k),
            keep.reshape(*lead, t * k))


def _combine_group(out_e: torch.Tensor, slot, st, sg, keep, t: int):
    """out_e [..., e*cap, d] -> y [..., t, d]: each token's k weighted
    expert outputs summed left to right in expert order (the order of the
    reference's segment sum over the expert-sorted assignments)."""
    *lead, n, d = out_e.shape
    g = math.prod(lead)
    oe = out_e.reshape(g, n, d)
    sl, tok = slot.reshape(g, -1), st.reshape(g, -1)
    contrib = (torch.gather(oe, 1, sl[..., None].expand(-1, -1, d))
               * sg.reshape(g, -1)[..., None].to(oe.dtype)
               * keep.reshape(g, -1)[..., None].to(oe.dtype))
    # every token holds k assignments: a stable sort by token keeps each
    # token's in expert order
    by_token = torch.sort(tok, dim=-1, stable=True).indices
    contrib = torch.gather(contrib, 1, by_token[..., None].expand(-1, -1, d))
    contrib = contrib.reshape(g, t, -1, d)
    y = contrib[:, :, 0]
    for j in range(1, contrib.shape[2]):
        y = y + contrib[:, :, j]
    return y.reshape(*lead, t, d)


def moe(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (out [b, s, d], aux loss).  Groups are the batch rows
    when s > 1, one flat group at decode (s == 1)."""
    b, s, d = x.shape
    e = cfg.n_experts
    if s > 1:
        g, tg, xg = b, s, x
    else:
        g, tg, xg = 1, b * s, x.reshape(1, b * s, d)

    logits = xg.float() @ p["router"].float()                     # [g, tg, e]
    probs = torch.softmax(logits, dim=-1)
    cap = _capacity(cfg, tg)
    buf, slot, st, sg, keep = _dispatch_group(cfg, xg, probs, cap)

    # the expert FFN, quantized per expert: groups fold into the token dim
    xe = buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = ctx.emm("moe_up", xe, p["wi"])
    gate, up = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate.float()).to(x.dtype) * up
    out = ctx.emm("moe_down", h, p["wo"])
    out_e = out.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    yf = _combine_group(out_e, slot, st, sg, keep, tg).to(x.dtype)
    yf = yf.reshape(b * s, d)

    if cfg.shared_expert:
        yf = yf + mlp(cfg, p["shared"], ctx, xg.reshape(1, b * s, d))[0]

    # Switch aux loss, global over all groups
    top1 = torch.argmax(probs, dim=-1).reshape(-1)
    assign_frac = torch.bincount(top1, minlength=e).float() / (g * tg)
    prob_frac = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(assign_frac * prob_frac)
    return yf.reshape(b, s, d), aux
