"""Cost, memory and collective accounting of a traced step — counterpart
of ``repro/analysis/hlo.py``.

PyTorch has no HLO.  What the reference reads from the compiled
per-device HLO text, the port reads from the program itself, traced on
one rank (``launch/dryrun.py``, on the meta device or on the card):

* :class:`CostCounter`, a ``TorchDispatchMode``, sees every aten op the
  step runs.  It counts the matmul-class flops that
  ``torch.utils.flop_counter`` knows (mm, bmm, attention, convolution:
  elementwise work is not counted, where XLA's cost analysis counts
  it), the bytes each op reads and writes (its operands and outputs once;
  views, allocations and collectives none), the ops by name
  (:func:`op_histogram`) and the peak of live storage.  The kernel sites
  (``kernels/accounting.py``) report their own work from their shapes,
  and the aten ops of a plain version inside them are not counted again,
  so the counts are the same on the meta device, the CPU and the card.
* ``parallel.collectives.recording`` takes the place of the HLO's
  collective ops: every call of the port's transport leaves a record
  ``(kind, result bytes a rank, group size)``, and
  :func:`collective_bytes` prices them with the reference's ring wire
  factors.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import accounting


def shape_bytes(x, dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of a tensor, or of a shape of ``dtype`` elements."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return math.prod(x) * dtype.itemsize


_WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
    "broadcast": lambda g: 1.0 if g > 1 else 0.0,
}


def collective_bytes(records: Iterable[Tuple[str, int, int]]) -> Dict[str, float]:
    """Per-kind wire bytes (one rank's) + op counts from the transport's
    records ``(kind, result bytes, group size)``, with ring factors:

        all-reduce       2 (g-1)/g * bytes
        all-gather         (g-1)/g * bytes   (bytes = gathered result)
        reduce-scatter     (g-1)   * bytes   (bytes = scattered result)
        all-to-all         (g-1)/g * bytes
        collective-permute         1 * bytes (point-to-point)
        broadcast                  1 * bytes (each member receives it once)

    Point-to-point arrives as ``send`` and ``recv`` records, the two
    halves of a transfer; on full-duplex links the busier direction sets
    the time, so ``collective-permute`` is the larger of the bytes sent
    and received (one HLO collective-permute is one of each)."""
    out = {k: 0.0 for k in _WIRE_FACTOR}
    counts = {k: 0 for k in _WIRE_FACTOR}
    p2p = {"send": [0, 0], "recv": [0, 0]}
    for kind, nbytes, g in records:
        if kind in p2p:
            p2p[kind][0] += nbytes
            p2p[kind][1] += 1
            continue
        out[kind] += _WIRE_FACTOR[kind](g) * nbytes
        counts[kind] += 1
    out["collective-permute"] += max(p2p["send"][0], p2p["recv"][0])
    counts["collective-permute"] += max(p2p["send"][1], p2p["recv"][1])
    out["total"] = sum(out[k] for k in _WIRE_FACTOR)
    out["counts"] = counts  # type: ignore[assignment]
    return out


def op_histogram(counts: Dict[str, int], top: int = 15) -> Dict[str, int]:
    """The ``top`` most frequent aten ops of a trace (:class:`CostCounter`
    ``.ops``): with ``remat`` the forward's ops come again in the
    backward."""
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])


_NO_BYTES_NS = ("c10d", "_c10d_functional", "_dtensor")
# allocations, and views that the schema does not mark as views
_NO_BYTES_OPS = ("empty", "empty_like", "empty_strided", "new_empty",
                 "new_empty_strided", "_unsafe_view", "lift_fresh")


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _plain(t) -> bool:
    """A tensor that holds its own storage (not a wrapper subclass such
    as DTensor, whose local tensor is what a rank holds)."""
    return type(t) is torch.Tensor or isinstance(t, torch.nn.Parameter)


class CostCounter(TorchDispatchMode):
    """Counts one traced step (see the module docstring).  Register the
    step's arguments with :meth:`arguments` before entering, its outputs
    with :meth:`outputs` after.

    ``flops`` (the kernel sites' operations included), ``int8_ops`` (of
    them, on int8 tensor cores), ``bytes``, ``ops`` {aten op: calls},
    ``op_bytes`` {aten op: bytes},
    ``kernels`` {site: {"calls", "ops", "bytes"}}, and ``memory()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.int8_ops = 0
        self.bytes = 0
        self.ops: Dict[str, int] = {}
        self.op_bytes: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._inside = 0            # > 0 inside a kernel site
        self._live = 0
        self.peak = 0
        self._tracked: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self._out = {"output": 0, "alias": 0}

    # -- storage -------------------------------------------------------------

    def _storage(self, t):
        if not _plain(t):
            return None
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None

    def _see(self, t) -> None:
        st = self._storage(t)
        if st is None or id(st) in self._tracked:
            return
        key, n = id(st), st.nbytes()
        self._tracked[key] = n
        self._live += n
        self.peak = max(self.peak, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        n = self._tracked.pop(key, None)
        if n is not None:
            self._live -= n

    def arguments(self, *trees) -> None:
        """Register the step's arguments (live from the start)."""
        for t in _tensors(trees):
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = self._storage(t)
            if st is not None and id(st) not in self._args:
                self._see(t)
                self._args[id(st)] = st.nbytes()

    def outputs(self, *trees) -> None:
        """Register the step's results: bytes of new storage, and bytes of
        results that alias an argument."""
        seen = set()
        for t in _tensors(trees):
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = self._storage(t)
            if st is None or id(st) in seen:
                continue
            seen.add(id(st))
            self._out["alias" if id(st) in self._args else "output"] += \
                st.nbytes()

    def memory(self) -> Dict[str, int]:
        """The reference's ``memory_analysis`` keys where the meaning
        matches: ``argument_size_in_bytes`` (storage of the arguments),
        ``output_size_in_bytes`` (new storage among the results),
        ``alias_size_in_bytes`` (results that are arguments, written in
        place), and ``peak_size_in_bytes``, the most storage live at once
        during the step, arguments included (``total_nonarg_bytes`` is
        that less the arguments: XLA's output + temp)."""
        arg = sum(self._args.values())
        return {"argument_size_in_bytes": arg,
                "output_size_in_bytes": self._out["output"],
                "alias_size_in_bytes": self._out["alias"],
                "peak_size_in_bytes": self.peak,
                "total_nonarg_bytes": self.peak - arg}

    # -- kernel sites ----------------------------------------------------------

    @contextlib.contextmanager
    def kernel(self, name: str, cost: Dict):
        """A kernel site's call: its analytic cost counted, the ops inside
        (and their temporaries) not."""
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0, "bytes": 0})
        k["calls"] += 1
        k["ops"] += cost["ops"]
        k["bytes"] += cost["bytes"]
        self.flops += cost["ops"]
        self.bytes += cost["bytes"]
        if cost["kind"] == "int8":
            self.int8_ops += cost["ops"]
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def __enter__(self):
        self._prev_counter = accounting.install(self)
        return super().__enter__()

    def __exit__(self, *exc):
        accounting.install(self._prev_counter)
        return super().__exit__(*exc)

    # -- aten ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in ins + outs:
            self._see(t)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not (func.is_view or func.namespace in _NO_BYTES_NS
                or name in _NO_BYTES_OPS):
            n = sum(shape_bytes(t) for t in ins + outs if _plain(t))
            self.bytes += n
            self.op_bytes[name] = self.op_bytes.get(name, 0) + n
        return out

    def cost(self) -> Dict[str, float]:
        """The reference's ``cost_analysis`` keys: "flops" and "bytes
        accessed", plus "int8 ops" (of the flops)."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "int8 ops": float(self.int8_ops)}
