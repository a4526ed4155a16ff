"""Logical-axis sharding rules for every param, batch, cache and
activation — counterpart of ``repro/parallel/sharding.py``.

Mesh axes: ("data", "model") on one pod, ("pod", "data", "model") across
pods; "pod" is the slow, hierarchical data-parallel axis.

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: a mesh axis name, a tuple of names, or None.  A mesh is a
``DeviceMesh`` with named dims, or, for planning alone, a ``{name: size}``
mapping.  Every spec goes through :func:`fit_spec`, which drops mesh axes
from the dims they do not divide, so every architecture shards on the same
mesh without special cases.

The port keeps ``layers`` (and ``enc_layers``) as a list of per-layer
dicts, where the reference stacks them on a leading [L, ...] dim with a
replicated spec entry; a port leaf's spec is the reference's with that
leading entry dropped.

The torch side: :func:`placements` turns a spec into the DTensor
placements of a mesh (a dim over ("pod", "data") shards on both mesh dims,
in mesh order), :func:`local_shard` cuts a rank's part of a full tensor
(``NamedSharding.shard_shape`` in the reference) and :func:`distribute`
turns a tree of full tensors into DTensors holding exactly those parts.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.parallel import collectives as C

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a planning mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def fit_spec(mesh, shape: Sequence[int], wanted: Sequence) -> Spec:
    """A spec for ``shape``: each dim keeps the greedy prefix of the axes
    it wants whose product divides it, and an axis used by one dim is not
    reused by a later one."""
    sizes = mesh_shape(mesh)
    out = []
    used = set()
    for size, axes in zip(shape, wanted):
        if axes is None:
            out.append(None)
            continue
        cand = (axes,) if isinstance(axes, str) else tuple(axes)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        keep = []
        prod = 1
        for a in cand:  # greedy prefix that divides
            if size % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        if keep:
            used.update(keep)
            out.append(tuple(keep) if len(keep) > 1 else keep[0])
        else:
            out.append(None)
    return tuple(out)


def dp_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


# ---------------------------------------------------------------------------
# Parameter rules, keyed on the leaf path (joined with "/")
# ---------------------------------------------------------------------------

_PARAM_RULES = [  # (regex on path, logical axes for the *trailing* dims)
    (r"embed$", ("tp", "embed")),          # [V, d] vocab-sharded
    (r"lm_head$", ("embed", "tp")),        # [d, V]
    (r"attn/wqkv$", ("embed", "tp")),
    (r"attn/bqkv$", ("tp",)),
    (r"attn/wo$", ("tp", "embed")),
    (r"cross/wq$", ("embed", "tp")),
    (r"cross/wkv$", ("embed", "tp")),
    (r"cross/wo$", ("tp", "embed")),
    (r"mlp/wi$", ("embed", "tp")),
    (r"mlp/wo$", ("tp", "embed")),
    (r"mlp/bi$", ("tp",)),
    (r"mlp/bo$", (None,)),
    (r"shared/mlp/wi$", ("embed", "tp")),
    (r"moe/router$", ("embed", None)),
    (r"moe/wi$", ("expert", None, None)),
    (r"moe/wo$", ("expert", None, None)),
    (r"moe/shared/wi$", ("embed", "tp")),
    (r"moe/shared/wo$", ("tp", "embed")),
    (r"ssm/in_zx$", ("embed", "tp")),
    (r"ssm/in_bcdt$", ("embed", None)),
    (r"ssm/out_proj$", ("tp", "embed")),
    (r"ssm/conv_x_w$", (None, "tp")),
    (r"ssm/conv_x_b$", ("tp",)),
    (r"ssm/norm_gain$", ("tp",)),
    (r"ln", (None,)),                       # any norm leaf: replicated
]

_LOGICAL = {
    "tp": "model",
    "expert": "model",
    "kv_heads": "model",
    "ssd_heads": "model",
    "seq": "model",
}

def _logical_to_mesh(axes, fsdp: bool):
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif a == "embed":
            out.append("data" if fsdp else None)
        elif a == "batch":
            out.append(("pod", "data"))
        else:
            out.append(_LOGICAL.get(a, a))
    return out


def leaf_spec(path: str, shape: Sequence[int], mesh, fsdp: bool = True) -> Spec:
    """The spec of one leaf of the port's params at ``path`` ('/'-joined,
    no list index: ``layers/attn/wqkv``)."""
    # pre-quantized weights ({"q","s"} dicts) share the dense rule
    path = re.sub(r"/(q|s)$", "", path)
    logical = None
    for pat, ax in _PARAM_RULES:
        if re.search(pat, path):
            logical = list(ax)
            break
    if logical is None:
        logical = [None] * len(shape)
    # pad/trim to rank
    logical = (logical + [None] * len(shape))[: len(shape)]
    return fit_spec(mesh, shape, _logical_to_mesh(logical, fsdp))


def param_specs(cfg, params, mesh, fsdp: bool = True):
    """A tree shaped like ``params`` (the port's: lists of per-layer
    dicts) holding each leaf's spec.  ``cfg`` is taken for the reference's
    signature; the rules read the paths and shapes alone."""
    del cfg

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, path) for v in tree]
        return leaf_spec(path, tuple(tree.shape), mesh, fsdp)

    return walk(params, "")


# ---------------------------------------------------------------------------
# Batch / cache / activation specs
# ---------------------------------------------------------------------------

def _tree_map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def batch_specs(mesh, batch_tree):
    """tokens/labels [b, s] (+ patches/frames [b, n, d]) sharded on batch."""
    dp = dp_axes(mesh)
    return _tree_map(lambda _, leaf: fit_spec(
        mesh, leaf.shape, [dp] + [None] * (len(leaf.shape) - 1)), batch_tree)


def cache_specs(cfg, mesh, cache_tree):
    """KV / SSM state specs.

    k/v      [L, b, s, kv, dh]: batch->dp, kv->model (else seq->model)
    conv_x   [L, b, K-1, di]  : di->model
    conv_bc  [L, b, K-1, 2n]  : replicated (small, shared across heads)
    ssm      [L, b, h, n, p]  : h->model
    memory   [b, frames, d]   : batch->dp
    """
    dp = dp_axes(mesh)
    sizes = mesh_shape(mesh)

    def spec_for(name, leaf):
        ndim = len(leaf.shape)
        if name in ("k", "v", "k_scale", "v_scale"):
            if cfg.n_kv_heads % sizes["model"] == 0:    # shard kv heads
                axes = [None, dp, None, "model", None]
            else:
                # flash-decoding-style sequence sharding (the decode then
                # writes the cache with the "select" update, which stays
                # local to a shard)
                axes = [None, dp, "model", None, None]
        elif name == "conv_x":
            axes = [None, dp, None, "model"]
        elif name == "conv_bc":
            axes = [None, dp, None, None]
        elif name == "ssm":
            axes = [None, dp, "model", None, None]
        elif name == "memory":
            axes = [dp, None, None]
        else:  # pos scalar etc.
            axes = [None] * ndim
        return fit_spec(mesh, leaf.shape, axes)

    return _tree_map(spec_for, cache_tree)


def replicated(mesh) -> Spec:
    del mesh
    return ()


def activation_spec(mesh, seq_shard: bool = False) -> Spec:
    """Residual-stream spec [b, s, d]: batch over dp; seq over model when
    sequence parallelism is on.  A one-axis entry is the name itself, as
    ``PartitionSpec`` normalizes it."""
    dp = dp_axes(mesh)
    return (dp[0] if len(dp) == 1 else dp or None,
            "model" if seq_shard else None, None)


# ---------------------------------------------------------------------------
# DTensor placements and a rank's shard
# ---------------------------------------------------------------------------

def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check(spec: Spec, names: Sequence[str]) -> None:
    seen = []
    for entry in spec:
        axes = entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}: DTensor shards a dim over "
                             "several mesh dims in mesh order only")
        seen += axes
    if len(seen) != len(set(seen)):
        raise ValueError(f"spec {spec!r} uses a mesh axis twice")


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    _check(spec, names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[names.index(a)] = Shard(d)
    return out


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape one rank holds of a global ``shape`` under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // mesh_axis_size(mesh, entry_axes(e) or None)
                 for n, e in zip(shape, spec))


def shard_slices(shape: Sequence[int], spec: Spec, mesh,
                 coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the part of a global ``shape`` that the rank at mesh
    coordinate ``coord`` ({axis: index}) holds: a dim over several axes is
    cut major to minor in the entry's order, as the reference's."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, entry in zip(shape, spec):
        idx, parts = 0, 1
        for a in entry_axes(entry):
            idx = idx * sizes[a] + coord[a]
            parts *= sizes[a]
        chunk = n // parts
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def coordinate(mesh) -> Dict[str, int]:
    """This rank's {axis: index} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_shard(t: torch.Tensor, spec: Spec, mesh,
                coord: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This rank's contiguous copy of a full tensor under ``spec`` (a
    copy even where the part is a contiguous view, which would keep the
    whole tensor's storage alive; a replicated leaf is the tensor itself,
    made contiguous)."""
    coord = coordinate(mesh) if coord is None else coord
    part = t[shard_slices(t.shape, spec, mesh, coord)]
    if part.numel() == t.numel():
        return part.contiguous()
    return part.clone(memory_format=torch.contiguous_format)


def as_dtensor(local: torch.Tensor, spec: Spec, mesh, shape, stride=None):
    """A DTensor of global ``shape`` from this rank's part under ``spec``
    (no communication)."""
    from torch.distributed.tensor import DTensor
    if stride is None:
        stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def distribute(tree, specs, mesh):
    """A tree of full tensors (every rank holds the same) as DTensors,
    each rank keeping exactly its :func:`local_shard` of each leaf."""
    coord = coordinate(mesh)

    def one(t, spec):
        return as_dtensor(local_shard(t.detach(), spec, mesh, coord), spec,
                          mesh, t.shape)

    return _zip_map(one, tree, specs)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def spec_of(dt) -> Spec:
    """A DTensor's spec (its placements read back: a tensor dim sharded on
    several mesh dims lists them in mesh order)."""
    entries = [[] for _ in range(dt.ndim)]
    for name, pl in zip(dt.device_mesh.mesh_dim_names, dt.placements):
        if pl.is_shard():
            entries[pl.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def full_tensor(dt) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank, gathered through
    ``collectives`` (one all-gather a sharded mesh dim, minor dims first),
    not DTensor's own collectives: those crash under gloo on CUDA tensors
    (torch 2.11 on an H100)."""
    mesh = dt.device_mesh
    local = dt.to_local()
    names = list(mesh.mesh_dim_names)
    for i in reversed(range(len(names))):
        pl = dt.placements[i]
        if pl.is_shard():
            local = torch.cat(C.all_gather(local, mesh.get_group(names[i])),
                              dim=pl.dim)
    return local


def reshard(dt, spec: Spec):
    """A DTensor laid out by ``spec`` instead (through the whole tensor)."""
    full = full_tensor(dt)
    return as_dtensor(local_shard(full, spec, dt.device_mesh), spec,
                      dt.device_mesh, full.shape)


def gather_tree(tree):
    """A tree with every DTensor leaf replaced by its whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v) for v in tree]
    return full_tensor(tree) if isinstance(tree, DTensor) else tree
