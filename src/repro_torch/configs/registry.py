"""Architecture name -> ModelConfig.  The port serves the dense GPT-2
family so far; the other architectures of ``repro/configs`` join with
their model families."""
from __future__ import annotations

from repro_torch.configs import gpt2
from repro_torch.models.common import ModelConfig

ARCHS = {"gpt2-small": (gpt2.GPT2_SMALL, gpt2.REDUCED)}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    full, small = ARCHS[arch]
    return small if reduced else full
