"""Architecture name -> ModelConfig.  The port serves dense decoders so
far (GPT-2 and qwen2-0.5b); the other architectures of ``repro/configs``
join with their model families."""
from __future__ import annotations

from repro_torch.configs import gpt2, qwen2_0_5b
from repro_torch.models.common import ModelConfig

ARCHS = {"gpt2-small": (gpt2.GPT2_SMALL, gpt2.REDUCED),
         "qwen2-0.5b": (qwen2_0_5b.CONFIG, qwen2_0_5b.REDUCED)}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    full, small = ARCHS[arch]
    return small if reduced else full
