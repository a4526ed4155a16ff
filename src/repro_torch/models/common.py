"""Shared model substrate: config, weight init, norms, rotary embeddings,
softcap, cross-entropy.

Counterpart of ``repro/models/common.py``.  ``ModelConfig`` is the
reference's frozen dataclass with the fields of all five families
(dense, MoE, SSM, hybrid, encoder-decoder); ``compute_dtype`` maps the
dtype name to a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.parallel import global_stats as GS


def pad_vocab(vocab: int, multiple: int = 128) -> int:
    """Pad vocab so embedding/vocab dims divide every mesh axis (Megatron
    convention)."""
    return ((vocab + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    block_pattern: Tuple[str, ...] = ("attn",)   # attn|local|global|moe|mamba

    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window_size: int = 4096                      # for "local" blocks
    rope_theta: float = 10000.0

    mlp_type: str = "swiglu"                     # swiglu|gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False                  # llama4-style shared expert
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # zamba2-style shared attention block applied every k mamba blocks
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500
    # vlm (internvl2) — patch embeds prepended to token embeds
    n_patches: int = 0

    norm: str = "rmsnorm"                        # rmsnorm|layernorm
    norm_eps: float = 1e-5
    sandwich_norm: bool = False
    scale_embed: bool = False
    tie_embeddings: bool = True
    dtype: str = "float32"                       # compute dtype
    remat: bool = False                          # activation checkpointing

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:                    # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def blocks(self) -> Tuple[str, ...]:
        """The full per-layer kind sequence (pattern tiled to n_layers)."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def family(self) -> str:
        """dense | moe | ssm | hybrid | encdec — selects the stack body."""
        if self.is_enc_dec:
            return "encdec"
        if self.shared_attn_every:
            return "hybrid"
        kinds = set(self.blocks)
        if kinds == {"mamba"}:
            return "ssm"
        if "moe" in kinds:
            return "moe"
        return "dense"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
               device="cuda") -> torch.Tensor:
    """Seeded normal weights with std 1/sqrt(fan_in); ``fan_in`` defaults
    to ``shape[0]``, as the reference's ``dense_init`` does."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w / math.sqrt(fan_in or shape[0])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gain.float())).to(dt)


def layernorm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * gain + bias).to(dt)


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["gain"], cfg.norm_eps)
    return layernorm(x, p["gain"], p["bias"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [hd/2]
    angles = positions[..., :, None].float() * freqs               # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                          # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy.  ``vocab_size`` is the real vocab: the
    padded logit columns are left out of the normalizer.  Under
    ``global_stats.data_parallel`` the mean's denominator is the token
    count of the whole batch across the data-parallel ranks."""
    logits = logits.float()
    pad = logits.shape[-1] - vocab_size
    if pad > 0:
        logits = torch.cat([logits[..., :vocab_size],
                            torch.full((*logits.shape[:-1], pad), -1e9,
                                       device=logits.device)], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        if not GS.active():
            return torch.mean(nll)
        n = torch.full((), float(nll.numel()), device=nll.device)
        return torch.sum(nll) / GS.global_sum(n)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(
        GS.global_sum(torch.sum(mask)), 1.0)
