"""The fused MUXQ linear: offline weight preparation and the online
gather -> shift -> per-token int8 quantize -> block-scaled int8 GEMM path.

Counterpart of ``repro/kernels/ops.py``.  ``MuxqWeights`` carries a
``gather_idx`` [K_pad] channel-gather map and an ``in_scale`` [K_pad]
per-slot multiplier (2^-e on the outlier run, 0 on padding slots, 1
elsewhere), so the online body construction is data-driven.  On a card
``muxq_linear`` launches two kernels: ``rowwise_quantize`` with the body
construction fused in, then ``muxq_gemm``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quantizers as Q
from repro_torch.kernels import ref
from repro_torch.kernels.muxq_gemm import muxq_gemm
from repro_torch.kernels.quantize import body_plain, rowwise_quantize


@dataclasses.dataclass
class MuxqWeights:
    """Offline-prepared weights for one linear layer."""
    w_int: torch.Tensor          # [K_pad, N] int8 (outlier rows first)
    sw: torch.Tensor             # [1, N] f32 per-out-channel scales
    block_scale: torch.Tensor    # [K_pad/bk] int32: 2^exp on outlier blocks
    gather_idx: torch.Tensor     # [K_pad] int32 source channel per slot
    in_scale: torch.Tensor       # [K_pad] f32: 2^-e outlier run, 0 pads, 1 else
    bk: int
    k_orig: Optional[int]        # pre-padding channel count (None when
                                 # rebuilt from a buffer dict)
    perm: Optional[np.ndarray] = None  # [K] offline permutation (info only)
    pad_out: int = 0             # zero channels inserted after the outliers
    pad_tail: int = 0            # zero channels appended at the end
    n_out: int = 0               # outlier channel count


def prepare_weights(w, outlier_mask: np.ndarray, exp_factor: int,
                    bk: int = 512, weight_bits: int = 8,
                    k_pad_to: Optional[int] = None) -> MuxqWeights:
    """Offline step: permute outlier channels to the front and zero-pad the
    outlier run up to a bk multiple, so normal channels never share a
    x2^e block.  ``k_pad_to`` forces a larger padded width (whole extra
    zero K-blocks at the tail).  ``w`` [K, N] is an array or a tensor; the
    weight work runs on its device (a tensor on the card packs there) and
    every field comes back on it."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float()
    else:
        w = torch.from_numpy(np.asarray(w, np.float32))
    dev = w.device
    k, n = w.shape
    bk = min(bk, k)
    mask = np.asarray(outlier_mask, bool)
    idx_out = np.nonzero(mask)[0]
    idx_norm = np.nonzero(~mask)[0]
    perm = np.concatenate([idx_out, idx_norm])
    n_out = len(idx_out)
    pad_out = (-n_out) % bk if n_out else 0
    n_blocks_out = (n_out + pad_out) // bk
    pad_tail = (-(k + pad_out)) % bk
    if k_pad_to is not None:
        extra = k_pad_to - (k + pad_out + pad_tail)
        if extra < 0 or extra % bk:
            raise ValueError(f"k_pad_to={k_pad_to} does not extend K={k} "
                             f"(+{pad_out + pad_tail} padding) by whole "
                             f"blocks of {bk}")
        pad_tail += extra

    w_perm = w[torch.from_numpy(perm).to(dev)]
    w_padded = torch.cat([w_perm[:n_out], w.new_zeros(pad_out, n),
                          w_perm[n_out:], w.new_zeros(pad_tail, n)])
    del w_perm
    k_pad = k + pad_out + pad_tail
    block_scale = np.ones(k_pad // bk, np.int32)
    block_scale[:n_blocks_out] = 2 ** exp_factor

    gather_idx = np.zeros(k_pad, np.int32)
    in_scale = np.zeros(k_pad, np.float32)
    gather_idx[:n_out] = idx_out
    in_scale[:n_out] = 2.0 ** (-exp_factor)
    gather_idx[n_out + pad_out: n_out + pad_out + len(idx_norm)] = idx_norm
    in_scale[n_out + pad_out: n_out + pad_out + len(idx_norm)] = 1.0

    w_int, sw = Q.quantize(w_padded, weight_bits, "per_channel")
    return MuxqWeights(w_int=w_int, sw=sw.reshape(1, -1),
                       block_scale=torch.from_numpy(block_scale).to(dev),
                       gather_idx=torch.from_numpy(gather_idx).to(dev),
                       in_scale=torch.from_numpy(in_scale).to(dev),
                       bk=bk, k_orig=k, perm=perm,
                       pad_out=pad_out, pad_tail=pad_tail, n_out=n_out)


def _permute_pad_shift(x2: torch.Tensor, mw: MuxqWeights) -> torch.Tensor:
    """Online body construction: gather channels into packed order
    (outliers first, zero padding in place) and shift the outlier run down
    by 2^e (paper Eq. 4)."""
    return body_plain(x2, mw.gather_idx, mw.in_scale)


def muxq_linear(x: torch.Tensor, mw: MuxqWeights, act_bits: int = 8,
                out_dtype=None) -> torch.Tensor:
    """Online path: permute -> shift outlier block down -> per-token int8
    quantize -> fused block-scaled GEMM.  On a card the first three steps
    are one kernel."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    x_int, sx = rowwise_quantize(x2, act_bits, gather_idx=mw.gather_idx,
                                 in_scale=mw.in_scale)
    y = muxq_gemm(x_int, mw.w_int, mw.block_scale, sx, mw.sw, bk=mw.bk)
    return y.reshape(*lead, -1).to(out_dtype)


def muxq_linear_ref(x: torch.Tensor, mw: MuxqWeights, act_bits: int = 8,
                    out_dtype=None) -> torch.Tensor:
    """Same math through the plain oracles, on any device."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    body = _permute_pad_shift(x.reshape(-1, x.shape[-1]), mw)
    x_int, sx = ref.rowwise_quantize_ref(body, act_bits)
    y = ref.muxq_gemm_ref(x_int, mw.w_int, mw.block_scale, sx, mw.sw, mw.bk)
    return y.reshape(*lead, -1).to(out_dtype)
