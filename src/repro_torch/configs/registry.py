"""Architecture name -> ModelConfig, as in ``repro/configs/registry.py``:
the reference's dense, MoE, SSM, hybrid and encoder-decoder
architectures, in its order."""
from __future__ import annotations

from typing import List

from repro_torch.configs import (dbrx_132b, gemma2_9b, gpt2, internvl2_2b,
                                 llama4_scout_17b, mamba2_370m, qwen1_5_110b,
                                 qwen2_0_5b, qwen2_5_14b, whisper_tiny,
                                 zamba2_1_2b)
from repro_torch.models.common import ModelConfig

# the reference's order
ARCHS = {"internvl2-2b": (internvl2_2b.CONFIG, internvl2_2b.REDUCED),
         "gemma2-9b": (gemma2_9b.CONFIG, gemma2_9b.REDUCED),
         "qwen2.5-14b": (qwen2_5_14b.CONFIG, qwen2_5_14b.REDUCED),
         "qwen1.5-110b": (qwen1_5_110b.CONFIG, qwen1_5_110b.REDUCED),
         "qwen2-0.5b": (qwen2_0_5b.CONFIG, qwen2_0_5b.REDUCED),
         "whisper-tiny": (whisper_tiny.CONFIG, whisper_tiny.REDUCED),
         "llama4-scout-17b-a16e": (llama4_scout_17b.CONFIG,
                                   llama4_scout_17b.REDUCED),
         "dbrx-132b": (dbrx_132b.CONFIG, dbrx_132b.REDUCED),
         "mamba2-370m": (mamba2_370m.CONFIG, mamba2_370m.REDUCED),
         "zamba2-1.2b": (zamba2_1_2b.CONFIG, zamba2_1_2b.REDUCED),
         "gpt2-small": (gpt2.GPT2_SMALL, gpt2.REDUCED)}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    full, small = ARCHS[arch]
    return small if reduced else full


def list_archs() -> List[str]:
    """The assigned architectures (gpt2-small, the paper's own family, is
    left out as in the reference)."""
    return [a for a in ARCHS if a != "gpt2-small"]
