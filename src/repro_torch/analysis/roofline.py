"""Three-term roofline on one NVIDIA H100 SXM — counterpart of
``repro/analysis/roofline.py``, on the card's constants.

    compute_s    = flops / PEAK_BF16
    memory_s     = bytes accessed / HBM_BW
    collective_s = collective wire bytes / NVLINK_BW

The counts are one rank's: ``launch/dryrun.py`` traces the program that
rank 0 of the world runs, so nothing is divided by the number of cards.
``model_flops`` (6·N·D to train, 2·N·D forward only; N the active
non-embedding parameters) is the analytic useful work, and
``model_flops / (flops * chips)`` exposes recomputation and redundant
work (remat, ranks that repeat each other's compute).

The peaks are NVIDIA's data-sheet rates for the H100 SXM, dense (no
sparsity), at its full 700 W power limit: a card set lower runs slower
under load, so print every share beside ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``.  Every number here
is arithmetic on these constants, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.common import ModelConfig

PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_INT8 = 1979e12         # OP/s, int8 tensor cores (MUXQ's uniform int8)
PEAK_F32 = 67e12            # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12            # B/s, HBM3
NVLINK_BW = 450e9           # B/s each way, to the other cards of the host


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float            # per rank (the reference's key names)
    hlo_bytes: float            # per rank
    coll_bytes: float           # per rank
    model_flops: float          # analytic, global
    chips: int
    compute_s_int8: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap upper bound on step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (flops * chips)."""
        tot = self.hlo_flops * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_s * self.chips * PEAK_BF16
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_s=self.step_s,
                 useful_fraction=self.useful_fraction, mfu_bound=self.mfu_bound)
        return d


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Non-embedding parameter count (analytic, matches init_params)."""
    d, f = cfg.d_model, cfg.d_ff
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * (h + 2 * kv) * dh + h * dh * d
    mlp = d * 2 * f + f * d if cfg.mlp_type == "swiglu" else 2 * d * f
    n = 0
    for kind in cfg.blocks:
        if kind == "mamba":
            di, ns, hs = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            n += d * 2 * di + d * (2 * ns + hs) + di * d
        elif kind == "moe":
            e = cfg.top_k if active_only else cfg.n_experts
            n += attn + e * (d * 2 * f + f * d)
            if cfg.shared_expert:
                n += d * 2 * f + f * d
        else:
            n += attn + mlp
    if cfg.shared_attn_every:  # zamba2's shared block counts once
        n += attn + mlp
    if cfg.n_enc_layers:
        n += cfg.n_enc_layers * (attn + mlp)
        n += cfg.n_layers * (d * h * dh + d * 2 * kv * dh + h * dh * d)  # cross
    return n


def model_flops(cfg: ModelConfig, tokens: int, mode: str) -> float:
    """6·N·D train / 2·N·D forward-only (N = active non-embedding params)."""
    n = param_count(cfg, active_only=True)
    per_tok = 6 * n if mode == "train" else 2 * n
    return float(per_tok) * tokens


def make_roofline(cost: Dict, coll: Dict, cfg: ModelConfig, tokens: int,
                  mode: str, chips: int, int8_fraction: float = 0.0) -> Roofline:
    """``cost`` carries "flops" and "bytes accessed" (one rank's), ``coll``
    the wire bytes under "total"; ``int8_fraction`` of the flops run at the
    int8 rate in ``compute_s_int8``."""
    flops = float(cost.get("flops", 0.0))
    byt = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0.0))
    compute_s_int8 = (flops * (1 - int8_fraction) / PEAK_BF16
                      + flops * int8_fraction / PEAK_INT8)
    return Roofline(
        compute_s=flops / PEAK_BF16,
        memory_s=byt / HBM_BW,
        collective_s=cb / NVLINK_BW,
        hlo_flops=flops, hlo_bytes=byt, coll_bytes=cb,
        model_flops=model_flops(cfg, tokens, mode),
        chips=chips, compute_s_int8=compute_s_int8,
    )
