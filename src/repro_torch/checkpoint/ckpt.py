"""Atomic directory bundles in the reference's format
(``repro/checkpoint/ckpt.py``: one ``<group>.npz`` per group plus
``meta.json``).  Pure numpy and json, no framework."""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import numpy as np


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A tree of dicts -> '/'-joined flat keys, the reference's
    ``_flatten`` format.  Inverse of :func:`nest`."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        flat.update(flatten(val, f"{prefix}/{key}" if prefix else str(key)))
    return flat


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


def save_bundle(path, npz_groups: Dict[str, Dict[str, np.ndarray]],
                meta: Dict[str, Any]) -> Path:
    """Write a bundle directory atomically: the groups and ``meta.json`` go
    to a temporary directory beside ``path``, which then replaces it by
    rename.  An existing bundle is moved aside first and removed only once
    the new one has landed, so a crash never leaves neither.  Empty groups
    are not written (they load as {})."""
    final = Path(path)
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=final.parent, prefix=".tmp_"))
    try:
        for group, arrays in npz_groups.items():
            if arrays:
                np.savez(tmp / f"{group}.npz",
                         **{k: np.asarray(v) for k, v in arrays.items()})
        (tmp / "meta.json").write_text(json.dumps(meta, default=str))
        old = final.parent / (final.name + ".old")
        if final.exists():
            if old.exists():
                shutil.rmtree(old)
            os.rename(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


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
