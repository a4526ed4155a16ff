"""KV page modes behind one quantize/dequantize seam — counterpart of
``repro/serve/kvq.py``.

Modes:

  * ``fp``   — pages at the pool dtype (parity mode, lossless);
  * ``int8`` — per-(position, head) abs-max int8 over ``head_dim``
    (:func:`repro_torch.serve.kvcache.quantize_kv`);
  * ``int4`` — MUXQ'd nibble pages: calibrated per-head outlier channels
    are divided by ``2^e`` (the paper's Eq. 4) before a symmetric 4-bit
    quantization, and the read path multiplies them back (Eq. 6).  K/V
    pack two values per byte (``[..., dh] -> [..., dh//2]`` int8) and
    scales store as bf16, so an int4 page costs exactly half an int8
    page: ``(dh/2 + 2) / (dh + 4)`` bytes per (position, head).

The outlier masks come from per-layer, per-head K/V channel amax gathered
by :class:`KVCalibCollector` over the dense calibration forwards
(``repro_torch.quantize.calibrate_model``), pooled across layers into one
``[kvh, dh]`` mask per K and V (:func:`pool_outlier_mask`) and stored as
the artifact's ``kv_calib`` section.

The mode of a per-layer cache dict is read from its key set
(:func:`from_cache`): int4 pages carry ``k_redist``/``v_redist`` rows,
int8 pages carry ``k_scale`` without them, fp pages carry neither.

This module imports nothing from ``repro_torch.models`` or
``repro_torch.kernels``, so the paged-attention plain version can share
:func:`unpack_int4`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.kvcache import quantize_kv

KV_MODES = ("fp", "int8", "int4")

INT4_MAX = 7                   # symmetric [-7, 7]: amax maps to +/-7
DEFAULT_EXP_FACTOR = 2         # MUXQ 2^e magnitude shift
DEFAULT_OUTLIER_RATIO = 4.0    # channel amax > ratio * head median => outlier
DEFAULT_MAX_FRAC = 0.25        # cap pooled outliers per head (top-k fallback)
_SCALE_FLOOR = 1e-6            # matches kvcache.quantize_kv's zero-vector floor


# ---------------------------------------------------------------------------
# Nibble packing: two int4 values per int8 byte along head_dim
# ---------------------------------------------------------------------------

def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """[..., dh] int8 values in [-8, 7] -> [..., dh//2] int8 bytes.

    Half-split layout: byte ``j`` holds channel ``j`` in its low nibble and
    channel ``j + dh//2`` in its high nibble.  Computed in int32, where
    every result already lies in [-128, 127], so the cast back is exact."""
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError(f"head_dim must be even to nibble-pack, got {dh}")
    h = dh // 2
    lo, hi = x[..., :h].int(), x[..., h:].int()
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """[..., dh//2] int8 bytes -> [..., dh] int8 values (sign-extended
    through int32 shifts, as the CUDA kernel does)."""
    p32 = p.int()
    lo = (p32 << 28) >> 28
    hi = (p32 << 24) >> 28
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


# ---------------------------------------------------------------------------
# The quantizer seam
# ---------------------------------------------------------------------------

class KVQuantizer:
    """One page mode's quantize (write) / dequantize (read) pair plus its
    pool-array layout."""

    mode: str = "fp"
    # symmetric integer ceiling of the mode's codes (None for fp pages): the
    # quality observer counts saturated codes of sampled pages against it
    qmax: Optional[int] = None

    def quantize(self, k, v) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def dequantize(self, parts, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def page_arrays(self, L, n_pages, ps, kvh, dh, device) -> Dict[str, torch.Tensor]:
        """Zero pool arrays, all laid out [L, n_pages, ps, ...]."""
        raise NotImplementedError

    def pool_state(self, L, kvh, dh, device) -> Dict[str, torch.Tensor]:
        """Non-page pool state stacked [L, ...] (int4: redistribution
        rows)."""
        return {}

    def bytes_per_token(self, kvh: int, dh: int) -> int:
        """Page bytes one token position costs across K and V (one layer)."""
        raise NotImplementedError

    def kernel_operands(self, cache) -> Dict[str, torch.Tensor]:
        """Keyword operands for ``paged_attention_decode`` beyond the pages."""
        return {}


class FpKVQuantizer(KVQuantizer):
    mode = "fp"

    def __init__(self, dtype=torch.bfloat16):
        self.dtype = dtype

    def quantize(self, k, v):
        return {"k": k.to(self.dtype), "v": v.to(self.dtype)}

    def dequantize(self, parts, dtype):
        return parts["k"].to(dtype), parts["v"].to(dtype)

    def page_arrays(self, L, n_pages, ps, kvh, dh, device):
        shape = (L, n_pages, ps, kvh, dh)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}

    def bytes_per_token(self, kvh, dh):
        return 2 * kvh * dh * torch.finfo(self.dtype).bits // 8


class Int8KVQuantizer(KVQuantizer):
    """Per-(position, head) abs-max int8 (``kvcache.quantize_kv``)."""

    mode = "int8"
    qmax = 127

    def quantize(self, k, v):
        return quantize_kv(k, v)

    def dequantize(self, parts, dtype):
        return ((parts["k"].float() * parts["k_scale"]).to(dtype),
                (parts["v"].float() * parts["v_scale"]).to(dtype))

    def page_arrays(self, L, n_pages, ps, kvh, dh, device):
        shape = (L, n_pages, ps, kvh, dh)
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}

    def bytes_per_token(self, kvh, dh):
        return 2 * kvh * (dh + 4)          # int8 payload + f32 scale

    def kernel_operands(self, cache):
        return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}


class Int4KVQuantizer(KVQuantizer):
    """MUXQ'd int4 nibble pages with calibrated outlier redistribution.

    ``k_redist``/``v_redist`` are ``[kvh, dh]`` (or ``[L, kvh, dh]``)
    multipliers: ``2^e`` on calibrated outlier channels, 1 elsewhere.  The
    write path divides by them before quantizing, the read path multiplies
    them back.  Scales are bf16."""

    mode = "int4"
    qmax = INT4_MAX
    scale_dtype = torch.bfloat16

    def __init__(self, k_redist, v_redist):
        self.k_redist = torch.as_tensor(k_redist, dtype=torch.float32)
        self.v_redist = torch.as_tensor(v_redist, dtype=torch.float32)

    def _q(self, x, redist):
        body = x.float() / redist.to(x.device)
        amax = torch.clamp_min(body.abs().amax(dim=-1, keepdim=True),
                               _SCALE_FLOOR)
        # divide by a tensor: PyTorch's CUDA division by a host scalar
        # multiplies by its reciprocal, not the reference's IEEE quotient
        s = (amax / torch.full((), float(INT4_MAX), device=amax.device)
             ).to(self.scale_dtype)
        xi = torch.clamp(torch.round(body / s.float()), -INT4_MAX, INT4_MAX)
        return pack_int4(xi.to(torch.int8)), s

    def quantize(self, k, v):
        ki, ks = self._q(k, self.k_redist)
        vi, vs = self._q(v, self.v_redist)
        return {"k": ki, "k_scale": ks, "v": vi, "v_scale": vs}

    def _dq(self, p, s, redist, dtype):
        x = unpack_int4(p).float() * s.float()
        return (x * redist.to(x.device)).to(dtype)

    def dequantize(self, parts, dtype):
        return (self._dq(parts["k"], parts["k_scale"], self.k_redist, dtype),
                self._dq(parts["v"], parts["v_scale"], self.v_redist, dtype))

    def page_arrays(self, L, n_pages, ps, kvh, dh, device):
        if dh % 2:
            raise ValueError(f"int4 pages need an even head_dim, got {dh}")
        shape = (L, n_pages, ps, kvh, dh // 2)
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=self.scale_dtype, device=device),
                "v_scale": torch.zeros(sshape, dtype=self.scale_dtype, device=device)}

    def pool_state(self, L, kvh, dh, device):
        def stack(r):
            r = r.to(device)
            if r.dim() < 3:
                r = r.expand(kvh, dh)[None].expand(L, kvh, dh)
            return r.contiguous()
        return {"k_redist": stack(self.k_redist),
                "v_redist": stack(self.v_redist)}

    def bytes_per_token(self, kvh, dh):
        return 2 * kvh * (dh // 2 + 2)     # nibble payload + bf16 scale

    def kernel_operands(self, cache):
        return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                "k_redist": cache["k_redist"], "v_redist": cache["v_redist"]}


def redist_from_mask(mask, exp_factor: int = DEFAULT_EXP_FACTOR) -> np.ndarray:
    """[kvh, dh] bool outlier mask -> [kvh, dh] f32 multiplier (2^e / 1)."""
    return np.where(np.asarray(mask, bool),
                    np.float32(2.0 ** exp_factor), np.float32(1.0))


def make_quantizer(mode: str, *, kvh: Optional[int] = None,
                   dh: Optional[int] = None, dtype=torch.bfloat16,
                   calib: Optional[Dict[str, np.ndarray]] = None) -> KVQuantizer:
    """Quantizer for a pool mode.  ``calib`` is the artifact's ``kv_calib``
    section (see :func:`build_kv_calib`); int4 without calibration runs with
    identity redistribution (plain symmetric int4) and needs ``kvh``/``dh``
    for its rows."""
    if mode == "fp":
        return FpKVQuantizer(dtype)
    if mode == "int8":
        return Int8KVQuantizer()
    if mode == "int4":
        e = int(calib["exp_factor"]) if calib and "exp_factor" in calib \
            else DEFAULT_EXP_FACTOR
        if calib and "k_mask" in calib:
            kr = redist_from_mask(calib["k_mask"], e)
            vr = redist_from_mask(calib["v_mask"], e)
        else:
            if kvh is None or dh is None:
                raise ValueError("uncalibrated int4 pages need kvh and dh")
            kr = vr = np.ones((kvh, dh), np.float32)
        return Int4KVQuantizer(kr, vr)
    raise ValueError(f"unknown kv mode {mode!r} (expected one of {KV_MODES})")


def from_cache(cache: Dict[str, torch.Tensor]) -> KVQuantizer:
    """Classify a per-layer cache dict by its key set: redistribution rows
    mean int4, bare scales mean int8, else fp."""
    if "k_redist" in cache:
        return Int4KVQuantizer(cache["k_redist"], cache["v_redist"])
    if "k_scale" in cache:
        return Int8KVQuantizer()
    return FpKVQuantizer(cache["k"].dtype)


# ---------------------------------------------------------------------------
# Calibration: per-layer per-head K/V channel amax -> pooled outlier masks
# ---------------------------------------------------------------------------

class KVCalibCollector:
    """KV observer collecting per-layer, per-head K/V channel amax.

    Installed over the dense calibration forwards through
    ``models.attention.set_kv_observer``; called with (site prefix, k, v)
    where k/v are the post-RoPE ``[b, s, kvh, dh]`` projections.  Stats
    accumulate on the host as a running max, keyed by layer prefix."""

    def __init__(self):
        self.k_amax: Dict[str, np.ndarray] = {}
        self.v_amax: Dict[str, np.ndarray] = {}

    def __call__(self, prefix: str, k, v) -> None:
        if k.dim() != 4 or v.dim() != 4:
            return                          # not [b, s, kvh, dh] self-attn KV
        for store, x in ((self.k_amax, k), (self.v_amax, v)):
            amax = np.max(np.abs(x.detach().float().cpu().numpy()),
                          axis=(0, 1))      # [kvh, dh]
            prev = store.get(prefix)
            store[prefix] = amax if prev is None else np.maximum(prev, amax)

    def stacked(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """([L, kvh, dh] k_amax, v_amax) in layer order, or None if the
        forward never reached an observed attention site."""
        if not self.k_amax:
            return None
        keys = sorted(self.k_amax, key=_layer_sort_key)
        return (np.stack([self.k_amax[p] for p in keys]),
                np.stack([self.v_amax[p] for p in keys]))


def _layer_sort_key(prefix: str):
    digits = "".join(c for c in prefix if c.isdigit())
    return (int(digits) if digits else 0, prefix)


def pool_outlier_mask(amax: np.ndarray, *,
                      ratio: float = DEFAULT_OUTLIER_RATIO,
                      max_frac: float = DEFAULT_MAX_FRAC) -> np.ndarray:
    """[L, kvh, dh] per-layer channel amax -> one pooled [kvh, dh] mask.

    Per (layer, head) a channel is an outlier when its amax exceeds
    ``ratio`` times the head's median channel amax; layer sets are UNIONed
    per head; a head whose union exceeds ``max_frac`` of head_dim keeps its
    top-k channels by pooled amax."""
    amax = np.asarray(amax, np.float32)
    L, kvh, dh = amax.shape
    med = np.maximum(np.median(amax, axis=-1, keepdims=True), _SCALE_FLOOR)
    mask = (amax > ratio * med).any(axis=0)             # union across layers
    cap = max(1, int(max_frac * dh))
    pooled = amax.max(axis=0)                           # [kvh, dh]
    for head in range(kvh):
        if int(mask[head].sum()) > cap:
            keep = np.argsort(pooled[head])[-cap:]
            capped = np.zeros(dh, bool)
            capped[keep] = True
            mask[head] = capped
    return mask


def build_kv_calib(collector: KVCalibCollector, *,
                   exp_factor: int = DEFAULT_EXP_FACTOR,
                   ratio: float = DEFAULT_OUTLIER_RATIO,
                   max_frac: float = DEFAULT_MAX_FRAC
                   ) -> Optional[Dict[str, np.ndarray]]:
    """Collector -> the artifact's ``kv_calib`` section: stacked per-layer
    amax (k/v_amax [L, kvh, dh]), pooled masks (k/v_mask [kvh, dh]) and the
    redistribution exponent.  None when no attention site was observed."""
    stacked = collector.stacked()
    if stacked is None:
        return None
    k_amax, v_amax = stacked
    return {
        "k_amax": k_amax, "v_amax": v_amax,
        "k_mask": pool_outlier_mask(k_amax, ratio=ratio, max_frac=max_frac),
        "v_mask": pool_outlier_mask(v_amax, ratio=ratio, max_frac=max_frac),
        "exp_factor": np.asarray(exp_factor, np.int32),
        "outlier_ratio": np.asarray(ratio, np.float32),
    }
