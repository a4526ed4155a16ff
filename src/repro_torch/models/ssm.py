"""Mamba2 block through the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060) — counterpart of ``repro/models/ssm.py``.

The full-sequence form is the dual one: within a chunk of ``ssm_chunk``
steps the recurrence is an attention-like product of ``C B^T`` with the
masked decay matrix, and across chunks a Python loop carries the
[b, h, n, p] state (the reference's ``lax.scan``).  Decode is the O(1)
recurrence  h <- a*h + dt*B(x)x,  y = C.h + D*x.

The three projections (``ssm_in_zx``: gate z and state input x;
``ssm_in_bcdt``: B, C and dt; ``ssm_out``) run through the quantization
ctx, so under a fused artifact they run on ``rowwise_quantize`` +
``muxq_gemm``.  The causal depthwise conv and the SSD itself are plain
torch, as the reference computes them in plain ``jnp``; the decay logs,
the dt-weighted inputs, B, C and the state stay f32 as there.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, rmsnorm

CONV_K = 4  # causal depthwise conv width


def _dims(cfg: ModelConfig):
    return cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Seeded weights of one Mamba2 block, the reference's shapes and
    scales."""
    d = cfg.d_model
    di, n, h, _ = _dims(cfg)

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device=device)
    return {
        "in_zx": dense_init(gen, (d, 2 * di), d, device),
        "in_bcdt": dense_init(gen, (d, 2 * n + h), d, device),
        "conv_x_w": normal((CONV_K, di), 0.2),
        "conv_x_b": torch.zeros(di, device=device),
        "conv_bc_w": normal((CONV_K, 2 * n), 0.2),
        "conv_bc_b": torch.zeros(2 * n, device=device),
        "A_log": torch.zeros(h, device=device),          # A = exp(A_log) = 1
        "dt_bias": torch.full((h,), -2.0, device=device),  # softplus ~= 0.12
        "D": torch.ones(h, device=device),
        "norm_gain": torch.zeros(di, device=device),
        "out_proj": dense_init(gen, (di, d), di, device),
    }


def _causal_conv(xc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_K: xc [b, s, ch]."""
    s = xc.shape[1]
    pad = F.pad(xc, (0, 0, CONV_K - 1, 0))
    out = sum(pad[:, i: i + s, :] * w[i] for i in range(CONV_K))
    return out + b


def ssd_chunked(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.  x [b, s, h, p], dt [b, s, h], B/C
    [b, s, n], A [h]; ``s0`` [b, h, n, p] the state before the first step
    (zeros when None).  Returns (y [b, s, h, p], final state
    [b, h, n, p] f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:  # right-pad with dt = 0 steps: a = 1, no injection, state inert
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // q

    la = -dt.float() * A                                  # log a_t [b, s, h]
    dtx = dt.float()[..., None] * x.float()               # [b, s, h, p]
    cum = torch.cumsum(la.reshape(b, nc, q, h), dim=2)    # inclusive
    dtx_c = dtx.reshape(b, nc, q, h, p)
    B_c = B.float().reshape(b, nc, q, n)
    C_c = C.float().reshape(b, nc, q, n)

    # intra-chunk: the attention-like dual form.  The mask goes inside the
    # exp (exp(-inf) = 0, as the reference's where), so no inf of the
    # upper triangle reaches the backward pass.
    G = torch.einsum("bcin,bcjn->bcij", C_c, B_c)          # [b, nc, q, q]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # cum_i - cum_j
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                              float("-inf")))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", G[..., None] * L, dtx_c)

    # inter-chunk: each chunk's injected state and decay, then the loop
    w_in = torch.exp(cum[:, :, -1:, :] - cum)              # [b, nc, q, h]
    s_in = torch.einsum("bcjn,bcjh,bcjhp->bchnp", B_c, w_in, dtx_c)
    a_chunk = torch.exp(cum[:, :, -1, :])                  # [b, nc, h]
    state = (torch.zeros((b, h, n, p), device=x.device) if s0 is None
             else s0.float())
    before = []
    for c in range(nc):
        before.append(state)                               # state BEFORE chunk
        state = a_chunk[:, c, :, None, None] * state + s_in[:, c]
    s_before = torch.stack(before, 1)                      # [b, nc, h, n, p]
    y_inter = (torch.einsum("bcin,bchnp->bcihp", C_c, s_before)
               * torch.exp(cum)[..., None])

    y = (y_intra + y_inter).reshape(b, s + pad, h, p)[:, :s]
    return y.to(x.dtype), state


def _project(cfg, p_, ctx, x):
    """Both input projections: (z, xc raw, bc raw, dt raw)."""
    di, n, _, _ = _dims(cfg)
    zx = ctx("ssm_in_zx", x, p_["in_zx"])
    bcdt = ctx("ssm_in_bcdt", x, p_["in_bcdt"])
    return zx[..., :di], zx[..., di:], bcdt[..., : 2 * n], bcdt[..., 2 * n:]


def _gate_norm_out(cfg, p_, ctx, y, z):
    y = y * F.silu(z.float()).to(y.dtype)                  # gate
    y = rmsnorm(y, p_["norm_gain"], cfg.norm_eps)
    return ctx("ssm_out", y, p_["out_proj"])


def ssm_block(cfg: ModelConfig, p_: dict, ctx, x: torch.Tensor,
              want_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence Mamba2 block from a zero state: x [b, s, d] ->
    ([b, s, d], the decode handoff or None).  With ``want_state`` the
    handoff holds the last CONV_K - 1 pre-conv channel vectors
    (``conv_x``, ``conv_bc``) and the final SSD state (``ssm``)."""
    b, s, _ = x.shape
    di, n, h, p = _dims(cfg)
    z, xc_raw, bc_raw, dt = _project(cfg, p_, ctx, x)

    xc = _causal_conv(xc_raw, p_["conv_x_w"].to(x.dtype),
                      p_["conv_x_b"].to(x.dtype))
    xc = F.silu(xc.float()).to(x.dtype)
    bc = _causal_conv(bc_raw, p_["conv_bc_w"].to(x.dtype),
                      p_["conv_bc_b"].to(x.dtype))
    bc = F.silu(bc.float()).to(x.dtype)

    dt = F.softplus(dt.float() + p_["dt_bias"])             # [b, s, h]
    A = torch.exp(p_["A_log"])                              # [h]
    xh = xc.reshape(b, s, h, p)
    y, s_final = ssd_chunked(cfg, xh, dt, bc[..., :n], bc[..., n:], A)
    y = y + (p_["D"][None, None, :, None] * xh.float()).to(y.dtype)
    out = _gate_norm_out(cfg, p_, ctx, y.reshape(b, s, di), z)

    state = None
    if want_state:
        state = {"conv_x": xc_raw[:, -(CONV_K - 1):].to(x.dtype),
                 "conv_bc": bc_raw[:, -(CONV_K - 1):].to(x.dtype),
                 "ssm": s_final}
    return out, state


def ssm_decode(cfg: ModelConfig, p_: dict, ctx, x: torch.Tensor,
               state: dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x [b, 1, d]; ``state`` {"conv_x": [b, K-1, di],
    "conv_bc": [b, K-1, 2n], "ssm": [b, h, n, p]}.  Returns (out, the new
    state; the arguments are not written)."""
    b = x.shape[0]
    di, n, h, p = _dims(cfg)
    z, xc_raw, bc_raw, dt = _project(cfg, p_, ctx, x)

    win_x = torch.cat([state["conv_x"], xc_raw[:, :1]], 1)     # [b, K, di]
    win_bc = torch.cat([state["conv_bc"], bc_raw[:, :1]], 1)
    # an f32 state beside bf16 activations makes the windows f32 (the cat
    # promotes); the weights follow, as the reference's einsum promotes
    xc = (torch.einsum("bkc,kc->bc", win_x,
                       p_["conv_x_w"].to(x.dtype).to(win_x.dtype))
          + p_["conv_x_b"].to(x.dtype))
    bc = (torch.einsum("bkc,kc->bc", win_bc,
                       p_["conv_bc_w"].to(x.dtype).to(win_bc.dtype))
          + p_["conv_bc_b"].to(x.dtype))
    xc = F.silu(xc.float()).to(x.dtype)
    bc = F.silu(bc.float()).to(x.dtype)
    B1, C1 = bc[..., :n].float(), bc[..., n:].float()

    dt1 = F.softplus(dt[:, 0].float() + p_["dt_bias"])     # [b, h]
    a = torch.exp(-dt1 * torch.exp(p_["A_log"]))            # [b, h]
    xh = xc.reshape(b, h, p).float()
    inject = torch.einsum("bn,bhp->bhnp", B1, dt1[..., None] * xh)
    s_new = a[..., None, None] * state["ssm"] + inject
    y = torch.einsum("bn,bhnp->bhp", C1, s_new)
    y = y + p_["D"][None, :, None] * xh
    out = _gate_norm_out(cfg, p_, ctx, y.reshape(b, 1, di).to(x.dtype), z)
    return out, {"conv_x": win_x[:, 1:], "conv_bc": win_bc[:, 1:],
                 "ssm": s_new}


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int,
                   dtype=torch.float32, device="cuda") -> dict:
    """Zero decode state, stacked over ``layers``."""
    di, n, h, p = _dims(cfg)
    return {
        "conv_x": torch.zeros((layers, batch, CONV_K - 1, di), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((layers, batch, CONV_K - 1, 2 * n),
                               dtype=dtype, device=device),
        "ssm": torch.zeros((layers, batch, h, n, p), device=device),
    }
