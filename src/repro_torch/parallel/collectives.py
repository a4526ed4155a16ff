"""Hand-rolled collectives over ``torch.distributed`` process groups —
counterpart of ``repro/parallel/collectives.py`` — and the one transport
layer that the port's distributed training goes through.

* :func:`hierarchical_psum` — reduce-scatter over the fast group, the small
  all-reduce over the slow group, all-gather over the fast group: the slow
  links carry 1/|fast| of the tensor.
* :func:`allgather_matmul` — the ring collective-matmul: X's row shards
  step around the group by ``isend``/``irecv`` while the shard in hand is
  multiplied, so the transfer of shard t+1 overlaps the product of shard t.
* :func:`ring_allreduce_reference` — the educational ring all-reduce.

A process group stands in for the reference's axis name; :func:`subgroup`
gives the group of a ``DeviceMesh``'s named dims through this rank.

Transport.  Gloo carries CUDA tensors for every collective used here
except point-to-point: ``send``/``recv`` of a device pointer aborts in
gloo's TCP transport (probed on an H100 with torch 2.11: "writev ... Bad
address").  Those ops (:data:`HOST_ROUTED`) move the buffer through host
memory inside the wrappers below, and :data:`HOST_COPIES` counts each
such buffer; the arithmetic stays on the tensor's device.

Accounting.  Inside :func:`recording`, every transport wrapper appends one
record ``(kind, result bytes a rank, group size)`` to the list it yields
(``analysis.hlo.collective_bytes`` prices them): ``all-reduce``,
``all-gather`` (the gathered result), ``reduce-scatter`` (the scattered
shard), ``broadcast``, and ``send`` / ``recv`` for the two halves of a
point-to-point transfer.  Outside it nothing is recorded.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# ops that a backend refuses on CUDA tensors -> moved through host memory
HOST_ROUTED = {"gloo": frozenset({"send", "recv"})}
# buffers moved through host memory, by op
HOST_COPIES: Dict[str, int] = {"send": 0, "recv": 0}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

_RECORDS: Optional[List[Tuple[str, int, int]]] = None


@contextmanager
def recording():
    """Yield a list that receives a record of every transport call made
    inside the block (an inner block keeps its own)."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _record(kind: str, t: torch.Tensor, group, nbytes=None) -> None:
    if _RECORDS is not None:
        _RECORDS.append((kind, t.numel() * t.element_size()
                         if nbytes is None else nbytes, axis_size(group)))


def _routed(op: str, t: torch.Tensor, group) -> bool:
    return (t.is_cuda
            and op in HOST_ROUTED.get(str(dist.get_backend(group)), ()))


# ---------------------------------------------------------------------------
# Groups
# ---------------------------------------------------------------------------

def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    return dist.get_rank(group)


def global_rank(group, index: int) -> int:
    """The global rank of ``group``'s member ``index``."""
    if group is None or group is dist.group.WORLD:
        return index
    return dist.get_global_rank(group, index)


def subgroup(mesh, names: Sequence[str]):
    """The process group over the mesh dims ``names`` through this rank
    (the other dims held at this rank's coordinate), members in mesh
    order.  Every rank must call it with the same ``names``: the groups of
    several dims are made by ``new_group``, one per coordinate of the
    other dims."""
    names = tuple(names)
    dims = list(mesh.mesh_dim_names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    grid = mesh.mesh
    keep = [dims.index(n) for n in names]
    other = [i for i in range(len(dims)) if i not in keep]
    grid = grid.permute(*other, *keep).reshape(
        -1, *[grid.shape[i] for i in keep])
    mine = None
    me = dist.get_rank()
    for block in grid:
        ranks = block.reshape(-1).tolist()
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` in place; returns ``t``."""
    _record("all-reduce", t, group)
    dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every member's ``t`` (same shape and dtype), in group order."""
    out = [torch.empty_like(t) for _ in range(axis_size(group))]
    _record("all-gather", t, group,
            len(out) * t.numel() * t.element_size())
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` [n*k, ...] summed over ``group``; member i keeps rows
    [i*k, (i+1)*k) (the reference's ``psum_scatter(..., tiled=True)``)."""
    n = axis_size(group)
    out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    _record("reduce-scatter", out, group)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src_index: int, group=None) -> torch.Tensor:
    """``t`` from ``group``'s member ``src_index``, in place."""
    _record("broadcast", t, group)
    dist.broadcast(t, src=global_rank(group, src_index), group=group)
    return t


class _Pending:
    """One point-to-point transfer in flight; ``wait()`` returns the
    received tensor on the caller's device (None for a send)."""

    def __init__(self, work, host=None, into=None):
        self.work, self.host, self.into = work, host, into

    def wait(self) -> Optional[torch.Tensor]:
        self.work.wait()
        if self.into is None:
            return None
        if self.host is not None:
            self.into.copy_(self.host)
        return self.into


def isend(t: torch.Tensor, dst_index: int, group=None) -> _Pending:
    dst = global_rank(group, dst_index)
    _record("send", t, group)
    if _routed("send", t, group):
        HOST_COPIES["send"] += 1
        host = t.detach().to("cpu")
        return _Pending(dist.isend(host, dst, group=group), host)
    t = t.contiguous()
    return _Pending(dist.isend(t, dst, group=group), t)


def irecv(like: torch.Tensor, src_index: int, group=None) -> _Pending:
    """Receive a tensor shaped like ``like`` from member ``src_index``."""
    src = global_rank(group, src_index)
    into = torch.empty_like(like, memory_format=torch.contiguous_format)
    _record("recv", into, group)
    if _routed("recv", into, group):
        HOST_COPIES["recv"] += 1
        host = torch.empty(into.shape, dtype=into.dtype)
        return _Pending(dist.irecv(host, src, group=group), host, into)
    return _Pending(dist.irecv(into, src, group=group), None, into)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's ``ppermute`` over ``i -> i + 1 (mod p)``: this
    member's ``x`` goes to the next, the previous one's comes back."""
    p, i = axis_size(group), axis_index(group)
    if p == 1:
        return x
    recv = irecv(x, (i - 1) % p, group)
    send = isend(x, (i + 1) % p, group)
    out = recv.wait()
    send.wait()
    return out


# ---------------------------------------------------------------------------
# The reference's collectives
# ---------------------------------------------------------------------------

def hierarchical_psum(x: torch.Tensor, fast=None, slow=None) -> torch.Tensor:
    """The sum of ``x`` over (slow x fast), with the slow group's traffic
    cut to 1/|fast| by a reduce-scatter / all-gather over the fast group
    around it."""
    n_fast = axis_size(fast)
    lead = x.shape[0]
    pad = (-lead) % n_fast    # pad the leading dim for an even scatter
    xp = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x
    shard = reduce_scatter(xp, fast)
    all_reduce(shard, "sum", slow)                    # small inter-pod hop
    full = torch.cat(all_gather(shard, fast), dim=0)
    return full[:lead] if pad else full


def allgather_matmul(x_shard: torch.Tensor, w_local: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Ring collective-matmul: Y = X @ W with X row-sharded [m/p, k] and W
    column-sharded [k, n/p] over ``group``; returns this member's column
    shard of Y, [m, n/p].  The next shard's transfer is in flight while
    the shard in hand is multiplied."""
    p, idx = axis_size(group), axis_index(group)
    m = x_shard.shape[0]
    out = x_shard.new_zeros((p * m, w_local.shape[1]))
    x_cur = x_shard
    for t in range(p):
        src = (idx - t) % p            # origin of the shard in hand
        if t < p - 1:
            recv = irecv(x_cur, (idx - 1) % p, group)
            send = isend(x_cur, (idx + 1) % p, group)
        out[src * m:(src + 1) * m] = x_cur @ w_local
        if t < p - 1:
            x_cur = recv.wait()
            send.wait()
    return out


def ring_allreduce_reference(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring all-reduce by p - 1 shifts, each member adding what arrives
    (the reference's order of additions)."""
    p = axis_size(group)
    if p == 1:
        return x
    acc = x
    buf = x
    for _ in range(p - 1):
        buf = ring_shift(buf, group)
        acc = acc + buf
    return acc


def ensure_grid(mesh) -> None:
    """Check that a mesh dim's group ranks its members by their mesh
    coordinate (what every gather here relies on)."""
    coord = mesh.get_coordinate()
    for name, c in zip(mesh.mesh_dim_names, coord):
        if dist.get_rank(mesh.get_group(name)) != c:
            raise RuntimeError(f"mesh dim {name!r}: group rank "
                               f"{dist.get_rank(mesh.get_group(name))} "
                               f"is not the coordinate {c}")

