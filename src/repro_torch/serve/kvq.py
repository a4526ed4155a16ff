"""KV page modes behind one quantize/dequantize seam — the fp and int8
part of ``repro/serve/kvq.py``.  The int4 MUXQ'd nibble mode and its
calibration are a later slice; asking for it raises.

The mode of a per-layer cache dict is read from its key set
(:func:`from_cache`): int8 pages carry ``k_scale``, fp pages do not.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.serve.kvcache import quantize_kv

KV_MODES = ("fp", "int8", "int4")


class KVQuantizer:
    """One page mode's quantize (write) pair plus its pool-array layout."""

    mode: str = "fp"

    def quantize(self, k, v) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def page_arrays(self, L, n_pages, ps, kvh, dh, device) -> Dict[str, torch.Tensor]:
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

    def page_arrays(self, L, n_pages, ps, kvh, dh, device):
        shape = (L, n_pages, ps, kvh, dh)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}


class Int8KVQuantizer(KVQuantizer):
    """Per-(position, head) abs-max int8 (``kvcache.quantize_kv``)."""

    mode = "int8"

    def quantize(self, k, v):
        return quantize_kv(k, v)

    def page_arrays(self, L, n_pages, ps, kvh, dh, device):
        shape = (L, n_pages, ps, kvh, dh)
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}

    def kernel_operands(self, cache):
        return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}


def make_quantizer(mode: str, *, dtype=torch.bfloat16) -> KVQuantizer:
    if mode == "fp":
        return FpKVQuantizer(dtype)
    if mode == "int8":
        return Int8KVQuantizer()
    if mode == "int4":
        raise NotImplementedError("int4 KV pages are not ported yet")
    raise ValueError(f"unknown kv mode {mode!r} (expected one of {KV_MODES})")


def from_cache(cache: Dict[str, torch.Tensor]) -> KVQuantizer:
    """Classify a per-layer cache dict by its key set."""
    if "k_redist" in cache:
        raise NotImplementedError("int4 KV pages are not ported yet")
    if "k_scale" in cache:
        return Int8KVQuantizer()
    return FpKVQuantizer(cache["k"].dtype)
