"""MUXQ quantization config (paper §3).

Counterpart of ``QuantConfig`` in ``repro/core/muxq.py``: the same frozen
dataclass, field for field, so a policy serialized by either package
loads in the other.  The decomposition math itself runs in the fused
kernel path (``repro_torch.kernels.ops``); the fake-quant forms of the
reference come with the fake backend in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core import outliers as O
from repro_torch.core import quantizers as Q

Method = Literal["fp", "naive", "muxq", "llm_int8", "smoothquant", "muxq_smooth"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization policy for one matmul site.  ``method`` says what math
    to apply; ``backend`` how to execute it (``fused`` = the packed
    single-GEMM MUXQ kernel path, ``fake`` = quantize-dequantize, ``fp`` =
    passthrough)."""
    method: Method = "muxq"
    backend: Literal["fake", "fused", "fp"] = "fake"
    act_bits: int = 8
    weight_bits: int = 8
    act_granularity: Q.Granularity = "per_tensor"
    weight_granularity: Q.Granularity = "per_tensor"
    exp_factor: int = 2                 # paper §3.3: 2 under the |x|>6 criterion
    outlier_threshold: float = O.DEFAULT_THRESHOLD
    outlier_mode: Literal["dynamic", "static"] = "dynamic"
    muxq_form: Literal["paper", "fused"] = "paper"
    real_int8: bool = False
    smooth_alpha: float = 0.5

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)

