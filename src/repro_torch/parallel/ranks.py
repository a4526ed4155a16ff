"""Run one function in ``tp`` spawned ranks of one process group.

    outs = run_ranks(fn, 2, (arg,), backend="gloo")

Each rank is a fresh process (the ``spawn`` start method: CUDA cannot be
initialized again in a forked child) that joins a ``torch.distributed``
group of ``tp`` ranks through a rendezvous file in a new temporary
directory (no port to collide with), calls ``fn(rank, *args)`` and hands
its return value back through a file.  ``fn`` and ``args`` are pickled,
so ``fn`` must be importable by its module path; CUDA tensors in ``args``
travel by CUDA IPC, CPU tensors through shared memory.  Under ``nccl``
rank r runs on ``cuda:r``; under ``gloo`` ``fn`` picks its device.
"""
from __future__ import annotations

import datetime
import gc
import pickle
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")


def _entry(rank: int, fn: Callable, tp: int, backend: str, tmp: str,
           timeout_s: float, box: list) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=tp, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        # the arguments leave the box so that they are freed here: a CUDA
        # tensor received by IPC tells its producer when it is released
        out = fn(rank, *box.pop())
        gc.collect()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn: Callable, tp: int, args: Sequence = (), *,
              backend: str = "gloo", timeout_s: float = 600.0) -> List:
    """``[fn(0, *args), ..., fn(tp - 1, *args)]``, each run in its own rank.

    A rank that raises makes this raise (the others are terminated); so
    does a run past ``timeout_s`` seconds, which is also every
    collective's timeout, so a rank that diverges from the others cannot
    hang the caller."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(
            _entry, args=(fn, tp, backend, tmp, timeout_s, [tuple(args)]),
            nprocs=tp, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{tp} ranks ran past {timeout_s} s")
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()   # free what the ranks released
        outs = []
        for r in range(tp):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
        return outs
