"""The sharded train step — the port's counterpart of
``jax.jit(make_train_step(cfg), in_shardings=(param specs, their AdamW
state's, batch specs))`` on a device mesh.

Params and the AdamW moments are DTensors laid out by
``sharding.param_specs``: every rank stores exactly its shard of each.
A step, in every rank:

1. gathers the full params (``sharding.full_tensor``; one all-gather a
   sharded mesh dim of a leaf);
2. takes its ``batch_specs`` shard of the batch (rows over the
   data-parallel axes);
3. runs ``launch.steps.loss_and_grads`` (the single-device step's forward
   and backward) under ``global_stats.data_parallel``, so that the loss's
   denominators and the MoE aux loss's top-1 counts are the whole batch's:
   each rank's loss is its share of the single-device loss;
4. sums the gradients over the data-parallel group (an all-reduce, or
   ``optim.compress``'s int8 error-feedback sum with
   ``compress_grads=True``, its residuals kept in the AdamW state under
   ``"ef"``);
5. keeps its shard of each gradient and runs ``adamw.apply_updates`` on
   its shards, the clipping norm summed over the ranks' shards with every
   replicated copy counted once.

Ranks that differ only along "model" hold the same batch rows and compute
the same gradients (no tensor-parallel compute yet); the gather at step 1
holds every rank's full params for the step.  Gathering layer by layer
and tensor-parallel compute along "model" are later work.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.context import FpCtx
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim import compress
from repro_torch.parallel import collectives as C
from repro_torch.parallel import global_stats as GS
from repro_torch.parallel import sharding as SH


def _map2(fn, a, b):
    """``fn`` over the leaves of ``a`` and the same places of ``b`` (dicts
    and lists are nodes; a spec tuple is a leaf)."""
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [_map2(fn, v, w) for v, w in zip(a, b)]
    return fn(a, b)


def spec_leaves(tree) -> list:
    """The leaves of a spec tree (spec tuples), in the params' leaf
    order."""
    out = []
    _map2(lambda a, _: out.append(a), tree, tree)
    return out


def _owner(spec, mesh, coord) -> bool:
    """True on the one rank of each set of replicas of a leaf: coordinate
    0 on every mesh dim that ``spec`` does not shard over."""
    used = set()
    for entry in spec:
        used.update(SH.entry_axes(entry))
    return all(coord[n] == 0 for n in mesh.mesh_dim_names if n not in used)


def sharded_norm(specs, mesh, coord, group=None):
    """``norm_fn`` for ``adamw.apply_updates`` on shards: each leaf's sum
    of squares over its shards (one all-reduce over the mesh's ``group``
    of a vector with a slot a leaf; each replicated copy counted once),
    then the sum over leaves in the single-device order."""
    owners = [_owner(s, mesh, coord) for s in spec_leaves(specs)]

    def norm(grads):
        leaves = adamw.tree_leaves(grads)
        part = torch.stack([
            torch.sum(torch.square(g.float())) if own
            else torch.zeros((), device=g.device)
            for g, own in zip(leaves, owners)])
        per_leaf = C.all_reduce(part, "sum", group)
        return torch.sqrt(sum(per_leaf[i] for i in range(len(leaves))))

    return norm


def make_sharded_train_step(cfg: ModelConfig, mesh, specs,
                            acfg: Optional[adamw.AdamWConfig] = None,
                            compress_grads: bool = False, device="cuda"):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` and ``opt_state["mu"|"nu"]`` are DTensor trees laid out by
    ``specs`` (``sharding.param_specs`` of the params; ``sharding.
    distribute`` makes them), ``opt_state["step"]`` a plain int32 tensor;
    ``batch`` holds the WHOLE batch (every rank the same) and each rank
    takes its rows.  The returned trees are laid out the same way.
    Metrics: loss, ce, aux (the whole batch's), lr, grad_norm.
    ``compress_grads`` sums the gradients with the int8 error-feedback
    all-reduce; ``opt_state["ef"]`` (per-rank residuals, full shape) is
    made on the first step."""
    acfg = acfg or adamw.AdamWConfig()
    C.ensure_grid(mesh)
    coord = SH.coordinate(mesh)
    dp = SH.dp_axes(mesh)
    dp_group = C.subgroup(mesh, dp)
    norm_fn = sharded_norm(specs, mesh, coord,
                           C.subgroup(mesh, mesh.mesh_dim_names))

    def shard_tree(tree):
        return _map2(lambda t, s: SH.local_shard(t, s, mesh, coord),
                     tree, specs)

    def step(params, opt_state, batch):
        layout = _map2(lambda s, t: (s, t.shape), specs, params)

        def as_dtensors(tree):
            return _map2(lambda t, sl: SH.as_dtensor(t, sl[0], mesh, sl[1]),
                         tree, layout)

        full = SH.gather_tree(params)
        bspecs = SH.batch_specs(mesh, batch)
        local_batch = {k: SH.local_shard(torch.as_tensor(v, device=device),
                                         bspecs[k], mesh, coord)
                       for k, v in batch.items()}
        with GS.data_parallel(dp_group):
            loss, parts, grads = loss_and_grads(cfg, full, local_batch,
                                                FpCtx())
        del full
        state = {"mu": _local(opt_state["mu"]), "nu": _local(opt_state["nu"]),
                 "step": opt_state["step"]}
        if compress_grads:
            err = opt_state.get("ef")
            if err is None:
                err = compress.init_error_state(grads)
            grads, err = compress.tree_ef_compressed_psum(grads, err,
                                                          dp_group)
        else:
            adamw.tree_map(lambda g: C.all_reduce(g, "sum", dp_group), grads)
        new_p, new_state, metrics = adamw.apply_updates(
            acfg, _local(params), shard_tree(grads), state, norm_fn=norm_fn)
        out_state = {"mu": as_dtensors(new_state["mu"]),
                     "nu": as_dtensors(new_state["nu"]),
                     "step": new_state["step"]}
        if compress_grads:
            out_state["ef"] = err
        totals = torch.stack([loss.detach(), parts["ce"].detach(),
                              parts["aux"].detach()])
        C.all_reduce(totals, "sum", dp_group)
        metrics.update(loss=totals[0], ce=totals[1], aux=totals[2])
        return as_dtensors(new_p), out_state, metrics

    return step


def _local(tree):
    return adamw.tree_map(lambda t: t.to_local(), tree)


def init_sharded(cfg: ModelConfig, params, mesh):
    """(specs, params as DTensors, the AdamW state with DTensor moments)
    from a full params tree that every rank holds (FSDP rules on)."""
    specs = SH.param_specs(cfg, params, mesh)
    dparams = SH.distribute(params, specs, mesh)
    state = adamw.init_state(params)
    return specs, dparams, {"mu": SH.distribute(state["mu"], specs, mesh),
                            "nu": SH.distribute(state["nu"], specs, mesh),
                            "step": state["step"]}


def local_bytes(tree) -> int:
    """Bytes this rank stores of a tree of DTensors (its shards)."""
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in adamw.tree_leaves(tree))


def global_bytes(tree) -> int:
    """Bytes of the whole tensors of a tree of DTensors."""
    return sum(t.numel() * t.element_size() for t in adamw.tree_leaves(tree))
