"""Meta-tensor stand-ins for every (arch x input-shape) dry-run cell —
counterpart of ``repro/launch/specs.py``.

The reference's ``jax.ShapeDtypeStruct`` leaves become tensors on the
``meta`` device (shape and dtype, no storage), built by the port's own
``init_cache``, ``init_int8_cache``, ``init_ssm_state`` and
``n_attn_layers``; ``launch/dryrun.py`` traces the steps on them.  As in
the reference, the modality frontends are stubs: [vlm] / [audio] archs
receive precomputed patch / frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.attention import init_cache, n_attn_layers
from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import init_ssm_state
from repro_torch.serve.kvcache import init_int8_cache

META = "meta"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: unbounded dense-attention KV cache"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _modality(cfg: ModelConfig, b: int, act_dtype) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.n_patches:
        out["patches"] = _meta((b, cfg.n_patches, cfg.d_model), act_dtype)
    if cfg.is_enc_dec:
        out["frames"] = _meta((b, cfg.n_audio_frames, cfg.d_model), act_dtype)
    return out


def batch_specs_abstract(cfg: ModelConfig, shape: ShapeSpec,
                         act_dtype=torch.bfloat16) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32),
            **_modality(cfg, b, act_dtype)}


def prefill_specs_abstract(cfg: ModelConfig, shape: ShapeSpec,
                           act_dtype=torch.bfloat16) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, s), torch.int32),
            **_modality(cfg, b, act_dtype)}


def cache_abstract(cfg: ModelConfig, shape: ShapeSpec,
                   kv_dtype=torch.bfloat16, int8_kv: bool = False,
                   batch: int = None) -> Dict[str, Any]:
    """Abstract KV/SSM cache for the decode cells (cache length =
    seq_len); ``batch`` overrides the shape's global batch (a rank's
    rows)."""
    b, s = batch or shape.global_batch, shape.seq_len
    fam = cfg.family
    if fam in ("dense", "moe", "encdec"):
        if int8_kv:
            cache = init_int8_cache(cfg, b, s, device=META)
        else:
            cache = init_cache(cfg, b, s, dtype=kv_dtype, device=META)
        if fam == "encdec":
            cache["memory"] = _meta((b, cfg.n_audio_frames, cfg.d_model),
                                    kv_dtype)
        return cache
    cache = init_ssm_state(cfg, b, cfg.n_layers, device=META)
    if fam == "hybrid":   # ssm states + the shared block's kv, one a use
        kvc = init_cache(cfg, b, s, dtype=kv_dtype, device=META,
                         layers=n_attn_layers(cfg))
        cache.update({"k": kvc["k"], "v": kvc["v"]})
    cache["pos"] = _meta((), torch.int32)
    return cache


def decode_specs_abstract(cfg: ModelConfig, shape: ShapeSpec,
                          int8_kv: bool = False) -> Dict[str, Any]:
    b = shape.global_batch
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": cache_abstract(cfg, shape, int8_kv=int8_kv)}


def synthetic_qparams(cfg: ModelConfig, frac: float = 0.02
                      ) -> Dict[str, np.ndarray]:
    """Static MUXQ outlier masks [L, channels] per bare site (stand-ins
    shaped like a calibration output; dry-run only — real runs
    calibrate): the reference's, bit for bit (the same generator, calls
    and site order).  :func:`eager_masks` names them as the port's ctx
    does."""
    rng = np.random.default_rng(0)
    L = cfg.n_layers
    d, f = cfg.d_model, cfg.d_ff

    def m(ch):
        k = max(1, int(frac * ch))
        out = np.zeros((L, ch), bool)
        for i in range(L):
            out[i, rng.choice(ch, k, replace=False)] = True
        return out

    fam = cfg.family
    sites: Dict[str, np.ndarray] = {}
    if fam in ("dense", "moe", "encdec", "hybrid"):
        sites["attn_qkv"] = m(d)
        sites["attn_out"] = m(cfg.n_heads * cfg.head_dim)
    if fam in ("dense", "encdec", "hybrid"):
        sites["mlp_up"] = m(d)
        sites["mlp_down"] = m(f)
    if fam == "moe":
        sites["moe_up"] = m(d)
        sites["moe_down"] = m(f)
        if cfg.shared_expert:
            sites["moe_shared_up"] = m(d)
            sites["moe_shared_down"] = m(f)
    if fam == "encdec":
        sites["cross_q"] = m(d)
        sites["cross_kv"] = m(d)
        sites["cross_out"] = m(cfg.n_heads * cfg.head_dim)
    if fam in ("ssm", "hybrid"):
        sites["ssm_in_zx"] = m(d)
        sites["ssm_in_bcdt"] = m(d)
        sites["ssm_out"] = m(cfg.d_inner)
    return sites


def eager_masks(cfg: ModelConfig, qparams: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
    """The reference's stacked masks as the port's ctx takes them, one
    [channels] mask a site name (``QuantCtx(masks=...)``,
    ``quantize.build_artifact``): row i of a bare site runs at
    ``layer{i}/``; an MoE layer's shared expert (``moe_shared_*``) at
    ``layer{i}/mlp_*``; the hybrid's shared block, which the reference
    runs at layer i with row i, at its use ``shared{j}/``."""
    out: Dict[str, np.ndarray] = {}
    shared_rows = ([i for i in range(cfg.n_layers)
                    if i % cfg.shared_attn_every == cfg.shared_attn_every - 1]
                   if cfg.shared_attn_every else [])
    for base, stack in qparams.items():
        if cfg.family == "hybrid" and not base.startswith("ssm_"):
            for j, i in enumerate(shared_rows):
                out[f"shared{j}/{base}"] = stack[i]
            continue
        name = base.replace("moe_shared_", "mlp_")
        for i in range(cfg.n_layers):
            out[f"layer{i}/{name}"] = stack[i]
    return out
