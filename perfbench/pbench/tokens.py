"""The byte-level token ids the served model reads: a BOS (256), then one
id a UTF-8 byte.  The reference encodes prompts with this copy."""
from __future__ import annotations

import numpy as np

BOS = 256


def encode(text: str) -> np.ndarray:
    return np.asarray([BOS] + list(text.encode("utf-8")), np.int64)
