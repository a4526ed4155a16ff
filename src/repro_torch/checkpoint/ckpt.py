"""Reading the atomic directory bundles the reference writes
(``repro/checkpoint/ckpt.py``: one ``<group>.npz`` per group plus
``meta.json``).  Pure numpy and json, no framework."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import numpy as np


def nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild a nested-dict tree from '/'-joined flat keys."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def load_bundle(path, groups: Iterable[str]
                ) -> Tuple[Dict[str, Dict[str, np.ndarray]], Dict[str, Any]]:
    """Load a bundle directory: ({group: {key: array}}, meta).  A missing
    group file loads as {} (empty groups are not written)."""
    d = Path(path)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for group in groups:
        f = d / f"{group}.npz"
        if f.exists():
            with np.load(f) as z:
                out[group] = {k: z[k] for k in z.files}
        else:
            out[group] = {}
    meta = json.loads((d / "meta.json").read_text())
    return out, meta
