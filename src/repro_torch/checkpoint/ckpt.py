"""Checkpoints and atomic directory bundles in the reference's format
(``repro/checkpoint/ckpt.py``).

Training checkpoints:

    <dir>/step_00000123/params.npz, opt.npz, meta.json
    <dir>/LATEST                  -> the step id, written last

Each step directory is written to a temporary directory and published by
rename, so a crash mid-write never corrupts the newest checkpoint; the
oldest beyond ``keep`` are removed.  The arrays are stored in the
reference's stacked layout (``convert.to_reference_layout``) under its
'/'-joined keys, so each package restores what the other wrote; restore
reads them back into the port's layout, checked against a template.

Bundles (``save_bundle``/``load_bundle``): one ``<group>.npz`` per group
plus ``meta.json``, published the same way.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import (as_port_opt_state, as_port_params,
                                 opt_state_to_reference_layout,
                                 to_reference_layout)


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


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

def _sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return isinstance(tree, DTensor)


def save(ckpt_dir, step: int, params, opt_state=None,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3) -> Path:
    """Write ``step_%08d`` (params, optional AdamW state, ``meta.json``
    with ``step`` and ``extra``) atomically, then ``LATEST``, then drop
    all but the newest ``keep`` step directories.

    Sharded trees (DTensor leaves, ``parallel.sharding.distribute``):
    every rank of the mesh calls ``save``; the leaves are gathered to
    whole tensors, rank 0 writes the one checkpoint and the other ranks
    wait for it at a barrier.  The files are the unsharded format, so a
    checkpoint restores at any mesh."""
    base = Path(ckpt_dir)
    final = base / f"step_{step:08d}"
    if _sharded(params):
        import torch.distributed as dist
        from repro_torch.parallel.sharding import gather_tree
        params = gather_tree(params)
        if opt_state is not None:
            opt_state = gather_tree(opt_state)
        if dist.get_rank() == 0:
            _write(base, final, step, params, opt_state, extra, keep)
        dist.barrier()
        return final
    _write(base, final, step, params, opt_state, extra, keep)
    return final


def _write(base: Path, final: Path, step: int, params, opt_state, extra,
           keep: int) -> None:
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=base, prefix=".tmp_"))
    try:
        np.savez(tmp / "params.npz", **flatten(to_reference_layout(params)))
        if opt_state is not None:
            np.savez(tmp / "opt.npz",
                     **flatten(opt_state_to_reference_layout(opt_state)))
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, **(extra or {})}, default=str))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    (base / "LATEST.tmp").write_text(str(step))
    os.replace(base / "LATEST.tmp", base / "LATEST")
    _gc(base, keep)


def _gc(base: Path, keep: int) -> None:
    steps = sorted(p for p in base.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    """The step ``LATEST`` names; if its directory is gone, the newest
    complete one; None when there is none."""
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    step = int(f.read_text().strip())
    if not (Path(ckpt_dir) / f"step_{step:08d}" / "meta.json").exists():
        steps = sorted(Path(ckpt_dir).glob("step_*/meta.json"))
        return int(json.loads(steps[-1].read_text())["step"]) if steps else None
    return step


def _specs(tree, prefix: str = "") -> Dict[str, Tuple[tuple, torch.dtype]]:
    """'/'-joined key -> (shape, dtype) of each leaf of a port-layout tree
    as the reference stores it: a list of per-layer dicts (``layers``,
    ``enc_layers``) stacks on [L, ...]."""
    if not isinstance(tree, dict):
        return {prefix: (tuple(tree.shape), tree.dtype)}
    out: Dict[str, Tuple[tuple, torch.dtype]] = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, list):
            out.update({k: ((len(val), *shape), dt)
                        for k, (shape, dt) in _specs(val[0], name).items()})
        else:
            out.update(_specs(val, name))
    return out


def _read(path: Path, template) -> Dict[str, Any]:
    """The npz at ``path`` as a nested reference-layout tree holding the
    template's leaves, each checked for presence and shape (the
    reference's messages, in its order of leaves: keys sorted at every
    level) and cast to the template's dtype."""
    specs = _specs(template)
    with np.load(path) as z:
        flat = {}
        for key in sorted(specs, key=lambda k: k.split("/")):
            shape, dtype = specs[key]
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = z[key]
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs model {shape}")
            flat[key] = arr.astype(torch.empty(0, dtype=dtype).numpy().dtype)
    return nest(flat)


def _like(template, tree):
    """``tree``'s leaves in ``template``'s order of keys (leaf order is
    the optimizer's order of summation)."""
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    if isinstance(template, list):
        return [_like(v, t) for v, t in zip(template, tree)]
    return tree


def _device(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def restore(ckpt_dir, step: int, params_template, opt_template=None,
            shardings=None, opt_shardings=None, mesh=None
            ) -> Tuple[Any, Optional[Any], Dict[str, Any]]:
    """Read ``step_%08d`` back into the port's layout on the templates'
    device: (params, AdamW state or None, meta).  The templates (the
    port's params and ``optim.adamw.init_state`` trees, whole or sharded)
    give each leaf's expected shape and dtype.

    ``shardings`` (a spec tree, ``parallel.sharding.param_specs``) and
    ``mesh`` restore the params as DTensors: each rank reads the
    unsharded files and keeps its shard, so a checkpoint saved at one mesh
    restores at another (elastic rescale).  ``opt_shardings`` lays out the
    AdamW moments the same way (``{"mu": specs, "nu": specs}``; ``step``
    stays a plain tensor)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    params = _like(params_template, as_port_params(
        None, _read(d / "params.npz", params_template),
        _device(params_template)))
    if shardings is not None:
        from repro_torch.parallel.sharding import distribute
        params = distribute(params, shardings, mesh)
    opt = None
    if opt_template is not None and (d / "opt.npz").exists():
        opt = _like(opt_template, as_port_opt_state(
            None, _read(d / "opt.npz", opt_template), _device(opt_template)))
        if opt_shardings is not None:
            from repro_torch.parallel.sharding import distribute
            opt.update({k: distribute(opt[k], opt_shardings[k], mesh)
                        for k in ("mu", "nu")})
    meta = json.loads((d / "meta.json").read_text())
    return params, opt, meta
