"""Seeded synthetic corpus (counterpart of ``repro/data/synthetic.py``): a
small PCFG-like generator with word-level structure, agreement patterns
and topic clustering, fully deterministic from its seed.  The same numpy
generator calls as the reference, so the same seed gives the same text.
"""
from __future__ import annotations

import numpy as np

_SUBJ = ["the model", "a kernel", "the compiler", "one pod", "the scheduler",
         "a tensor", "the optimizer", "this chip", "the cache", "a shard"]
_VERB = ["reduces", "computes", "shards", "quantizes", "emits", "fuses",
         "streams", "overlaps", "gathers", "scatters"]
_OBJ = ["the activations", "all gradients", "a matmul", "the outliers",
        "its buffers", "the blocks", "every channel", "the lattice",
        "those weights", "the tokens"]
_ADV = ["quickly", "exactly", "lazily", "twice", "in parallel", "per layer",
        "at scale", "on device", "without stalls", "in int8"]
_CONJ = ["and then", "so that", "while", "because", "after which"]


def sentence(rng: np.random.Generator) -> str:
    s = f"{rng.choice(_SUBJ)} {rng.choice(_VERB)} {rng.choice(_OBJ)}"
    if rng.random() < 0.5:
        s += f" {rng.choice(_ADV)}"
    if rng.random() < 0.3:
        s += f" {rng.choice(_CONJ)} {rng.choice(_SUBJ)} {rng.choice(_VERB)} {rng.choice(_OBJ)}"
    return s + ". "


def corpus(n_sentences: int = 20_000, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return "".join(sentence(rng) for _ in range(n_sentences))
