"""INT8 gradient all-reduce with error feedback — counterpart of
``repro/optim/compress.py``.

Over a data-parallel process group:

    acc   = g + err                      (error feedback carry-in)
    s     = max over ranks |acc| / 127   (shared scale -> exact int sum)
    q     = round(acc / s)  in int8 range (half to even, as jnp.round)
    total = sum over ranks of q, times s (int32 sum: no overflow < 2^23 ranks)
    err'  = acc - q * s                  (local quantization residual)

Error feedback makes the compression unbiased over time: the residual is
re-injected next step (Karimireddy et al. 2019).  Wire traffic: 1 byte a
gradient element plus one scalar (sent as int32 here: gloo and NCCL sum
int32).  The sharded train step reduces its gradients this way when
``compress=True``, the error state carried in the AdamW state (``"ef"``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.parallel import collectives as C


def ef_quantize(acc: torch.Tensor, amax: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 codes in [-127, 127], scale) of ``acc`` at the shared
    ``amax``.  Divides by device tensors, never by a host scalar (CUDA
    would multiply by its reciprocal)."""
    s = torch.clamp_min(amax, 1e-12) / torch.full((), 127.0,
                                                  device=amax.device)
    q = torch.clamp(torch.round(acc / s), -127, 127).to(torch.int32)
    return q, s


def ef_compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor: (the compressed sum of ``g`` over ``group``, the new
    error-feedback state)."""
    acc = g.float() + err
    amax = C.all_reduce(torch.max(torch.abs(acc)), "max", group)
    q, s = ef_quantize(acc, amax)
    total = C.all_reduce(q.clone(), "sum", group).float() * s
    new_err = acc - q.float() * s
    return total, new_err


def tree_ef_compressed_psum(grads, err_tree, group=None):
    """The tree version; ``err_tree`` is carried in the optimizer state."""
    out = [ef_compressed_psum(g, e, group)
           for g, e in zip(tree_leaves(grads), tree_leaves(err_tree))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
