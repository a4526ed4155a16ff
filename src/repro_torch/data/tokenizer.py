"""Byte-level tokenizer: ids 0..255 = bytes; 256 = BOS, 257 = EOS,
258 = PAD (same ids as ``repro/data/tokenizer.py``)."""
from __future__ import annotations

import numpy as np

BOS, EOS, PAD = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, bos: bool = True, eos: bool = False) -> np.ndarray:
    ids = list(text.encode("utf-8"))
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return np.asarray(ids, np.int32)


def decode(ids) -> str:
    bs = bytes(int(i) for i in ids if 0 <= int(i) < 256)
    return bs.decode("utf-8", errors="replace")
