"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  Builds run at first use, all sources in parallel (one
``nvcc`` process each), into ``build/repro_torch_kernels/`` at the root of
the checkout; a library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt and an
unchanged one is reused.  No
``--use_fast_math``: the kernels' divisions and roundings must match the
plain PyTorch versions bit for bit.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

SOURCES = {
    "rowwise_quantize": "rowwise_quantize.cu",
    "muxq_gemm": "muxq_gemm.cu",
    "paged_attention": "paged_attention.cu",
    "flash_attention": "flash_attention.cu",
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argument types of each library's ``<name>_launch`` C function; every one
# takes the stream last and returns cudaGetLastError()
SIGNATURES = {
    "rowwise_quantize": [_P] * 5 + [_I] * 5 + [_P],
    "muxq_gemm": [_P] * 6 + [_I] * 5 + [_P],
    "paged_attention": [_P] * 11 + [_I] * 10 + [_F] * 2 + [_I] * 2 + [_P],
    "flash_attention": [_P] * 5 + [_I] * 8 + [_F] * 2 + [_I] + [_P],
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LAUNCHERS: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc on first use")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all) in parallel; returns
    {name: compiler output} for the ones built now (``verbose`` adds
    ``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises with the compiler's output if any build fails."""
    todo = {n: _target(n) for n in (names or SOURCES)}
    todo = {n: t for n, t in todo.items() if not t[1].exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = {}
    for n, (src, out) in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
        procs[n] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, out, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def launcher(name: str) -> Callable[..., int]:
    """The C function ``<name>_launch`` of one kernel's library, with its
    signature declared; built and loaded on first use."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(_target(name)[1])), f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn


_SM_COUNT: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels' grid plans
    size themselves to it)."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError's code)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
