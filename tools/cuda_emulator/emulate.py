"""Run the port's CUDA kernels (``src/repro_torch/csrc``) on the CPU: a
host emulation of their CUDA source.  It checks a kernel's indexing,
fragment layouts, masks, split schedule and arithmetic where there is no
card and no ``nvcc``.

The ``.cu`` sources and their headers are compiled by the host C++
compiler against ``include/``:
- each block's threads are OS threads;
- ``__syncthreads``, ``__syncwarp`` and shuffles are barriers;
- ``mma.sync`` and ``ldmatrix`` gather the warp's fragments and compute
  from them in the PTX ISA's layouts;
- a tensor-core sum truncates every addend at the largest one's f32 ulp
  and rounds toward zero.  On the H100 that gave f32 errors of the size
  the card shows.
- an int8 ``mma.sync`` sums exactly, modulo 2^32;
- a ``cp.async`` copy lands when a ``wait_group`` covers its committed
  group, and a thread that ends with copies in flight aborts;
- a thread block cluster's blocks run at once, with a cluster barrier and
  each other's shared memory mapped; a grid's clusters (single blocks
  without a cluster launch) run one after the other, in the order that
  ``patch(block_order=...)`` names (forward, reverse or shuffled).

It says nothing of speed, occupancy, races between threads, or what
``nvcc`` accepts.

    PYTHONPATH=src python tools/cuda_emulator/emulate.py build
    PYTHONPATH=src python tools/cuda_emulator/emulate.py smoke

``smoke`` runs ``chip_smoke.py`` with the reduced configurations and a
short flash shape.  Every kernel runs in emulation (the GEMM's plain
version, counted as a launch, where a reduced width makes K-blocks
narrower than the kernel's 64-wide K tile) and the timers are stubbed.
It takes about 24 minutes on 8 cores (phase 16's emulated ranks about
4).  ``patch()`` points the wrappers' launches at the emulated
libraries, so that every kernel's ``_launch`` runs on CPU tensors
(``tests/test_torch_attention_emulated.py``,
``tests/test_torch_gemm_emulated.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
INCLUDE = Path(__file__).resolve().parent / "include"
BUILD_DIR = ROOT / "build" / "cuda_emulator"
KERNELS = ("paged_attention", "flash_attention", "muxq_gemm", "rowwise_quantize")
# the two lines of the sources that the host compiler cannot take
LAUNCH = ("kern<<<grid, threads, smem, st>>>(args...);",
          "emu_launch(kern, grid, threads, smem, args...);")
SHARED = ("extern __shared__ __align__(16) unsigned char smem_raw[];",
          "unsigned char* smem_raw = emu_shared();")
CXX_FLAGS = ("-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
             "-ffp-contract=off", "-w", "-x", "c++")


def compiler() -> str:
    for cand in ("g++", "c++", "clang++"):
        if shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler for the kernel emulation")


def build() -> Dict[str, Path]:
    """Compile the emulated kernels (once per content of the sources and
    of ``include/``); returns {kernel: shared library}."""
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256()
    for f in files + sorted(INCLUDE.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:12]
    libs = {n: out / f"lib{n}.so" for n in KERNELS}
    if all(p.exists() for p in libs.values()):
        return libs
    for name, (old, _) in (("launch.cuh", LAUNCH),
                           *((f"{n}.cu", SHARED) for n in KERNELS)):
        if old not in (CSRC / name).read_text():
            raise RuntimeError(f"{name} no longer holds {old!r}: update the "
                               "emulation")
    src = out / f"src.{os.getpid()}"
    src.mkdir(parents=True, exist_ok=True)
    for f in files:
        text = f.read_text()
        for old, new in (LAUNCH, SHARED):
            text = text.replace(old, new)
        (src / f.name).write_text(text)
    shutil.copy(INCLUDE / "ptx.cuh", src / "ptx.cuh")
    cxx = compiler()
    procs = {}
    for n in KERNELS:
        tmp = out / f"lib{n}.{os.getpid()}.tmp.so"
        procs[n] = (tmp, subprocess.Popen(
            [cxx, *CXX_FLAGS, "-I", str(INCLUDE), "-o", str(tmp),
             str(src / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{n}:\n{log}")
        else:
            os.replace(tmp, libs[n])
    shutil.rmtree(src, ignore_errors=True)
    if failed:
        raise RuntimeError("emulated build failed for " + "\n".join(failed))
    return libs


@contextlib.contextmanager
def patch(n_sm: int = 132, block_order: str = "forward"):
    """Within the block, the wrappers' launches (``_launch``) call the
    emulated kernels on CPU tensors, on a card of ``n_sm`` SMs, running a
    grid's blocks in ``block_order``: "forward", "reverse" or
    "shuffle:<seed>"."""
    import torch
    from repro_torch.kernels import build as kbuild

    libs, fns = build(), {}

    def launcher(name):
        if name not in fns:
            fn = getattr(ctypes.CDLL(str(libs[name])), f"{name}_launch")
            fn.argtypes = kbuild.SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns[name] = fn
        return fns[name]

    saved = kbuild.launcher, kbuild.sm_count, torch.cuda.current_stream
    saved_order = os.environ.get("CUDA_EMU_BLOCK_ORDER")
    kbuild.launcher = launcher
    kbuild.sm_count = lambda device: n_sm
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(
        cuda_stream=None)
    os.environ["CUDA_EMU_BLOCK_ORDER"] = block_order
    try:
        yield
    finally:
        kbuild.launcher, kbuild.sm_count, torch.cuda.current_stream = saved
        if saved_order is None:
            os.environ.pop("CUDA_EMU_BLOCK_ORDER", None)
        else:
            os.environ["CUDA_EMU_BLOCK_ORDER"] = saved_order


def smoke() -> int:
    """``chip_smoke.py`` on the CPU: reduced configs (gemma2's paged rows 24
    positions past its reduced window of 8), flash at s 160, the kernels
    emulated, no timings.  Returns its exit code."""
    import torch
    from repro_torch.kernels import build as kbuild

    out_dir = BUILD_DIR / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (ROOT / "chip_smoke.py").read_text()
    for old, new in (
            ('torch.device("cuda")', 'torch.device("cpu")'),
            ('get_config("gpt2-small")', 'get_config("gpt2-small", reduced=True)'),
            ('get_config("qwen2-0.5b")', 'get_config("qwen2-0.5b", reduced=True)'),
            ('get_config("qwen2.5-14b")', 'get_config("qwen2.5-14b", reduced=True)'),
            ('get_config("gemma2-9b")', 'get_config("gemma2-9b", reduced=True)'),
            ("wide = {a: get_config(a) for a in WIDE_ARCHS}",
             "wide = {a: get_config(a, reduced=True) for a in WIDE_ARCHS}"),
            ("moe_wide = {a: get_config(a) for a in MOE_ARCHS}",
             "moe_wide = {a: get_config(a, reduced=True) for a in MOE_ARCHS}"),
            ('get_config("llama4-scout-17b-a16e")',
             'get_config("llama4-scout-17b-a16e", reduced=True)'),
            ('get_config("dbrx-132b")', 'get_config("dbrx-132b", reduced=True)'),
            ("fam = {a: get_config(a) for a in FAMILY_ARCHS}",
             "fam = {a: get_config(a, reduced=True) for a in FAMILY_ARCHS}"),
            ("WINDOW_SPAN = 600 ", "WINDOW_SPAN = 24 "),
            ("fb, fs, fh, fkv, fdh = 1, 2048, 14, 2, 64",
             "fb, fs, fh, fkv, fdh = 1, 160, 14, 2, 64"),
            ("activities=[ProfilerActivity.CPU,\n                             "
             "ProfilerActivity.CUDA]", "activities=[ProfilerActivity.CPU]"),
            ("ROOT = Path(__file__).resolve().parent", f"ROOT = Path({str(out_dir)!r})"),
            ('sys.path.insert(0, str(ROOT / "src"))', "pass"),
            ("    dev = torch.device(device)\n",
             "    dev = torch.device(device)\n    import emulate\n"
             "    emulate.route_wrappers()\n    emulated = emulate.patch()\n"
             "    emulated.__enter__()\n")):
        if old not in text:
            raise RuntimeError(f"chip_smoke.py no longer holds {old!r}")
        text = text.replace(old, new)
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.get_device_name = lambda *a: "cpu (emulated kernels)"
    torch.cuda.device_count = lambda: 1
    kbuild.build = lambda *a, **k: {}

    route_wrappers()
    # a module on disk, so that phase 16's spawned ranks import its
    # ``tp_rank`` by name (and this module, to route their kernels too)
    (out_dir / "chip_smoke_emulated.py").write_text(text)
    sys.path[:0] = [str(out_dir), str(Path(__file__).resolve().parent)]
    import chip_smoke_emulated as ns
    ns.time_ms = lambda torch, fn, flush, iters=20: (fn(), (0.0, (0.0, 0.0)))[1]
    ns.call_ms = lambda torch, fn, iters=50: 0.0
    ns.event_times = lambda torch, fn, n: [(fn(), 0.0)[1]]
    ns.smi_line = lambda: "cpu (emulated kernels), 0 W"
    with patch():
        return ns.main()


def route_wrappers() -> None:
    """Point the kernels' wrappers at their ``_launch`` for CPU tensors,
    where they would take the plain versions (the GEMM's plain version
    where reduced qwen2's 56-wide K-blocks are narrower than its K tile);
    with :func:`patch` entered, the launches run in emulation.  The entry
    points stay as they are (their accounting included): only the device
    choice inside them (``_run``) is replaced, and a tensor on another
    device (the dry-run's meta tensors) keeps the plain path."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import muxq_gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quantize as RQ

    def paged(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
              k_redist, v_redist, window, softcap, plan_kv_heads):
        if PA._PAGED_IMPL == "ref":
            return PA.paged_attention_plain(
                q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
                v_scale=v_scale, k_redist=k_redist, v_redist=v_redist,
                window=window, softcap=softcap)
        return PA._launch(q, k_pages, v_pages, page_table, pos, k_scale,
                          v_scale, k_redist, v_redist, window, softcap,
                          plan_kv_heads)

    def flash(q, k, v, *, causal=True, window=None, softcap=None):
        return FA._launch(q, k, v, causal, window, softcap)

    def gemm(x_int, w_int, block_scale, sx, sw, bk):
        if bk % G._BK_TILE:     # reduced qwen2: K-blocks of 56 channels
            G.LAUNCHES += 1
            return G.muxq_gemm_plain(x_int, w_int, block_scale, sx, sw, bk)
        return G._launch(x_int, w_int, block_scale, sx, sw, bk)

    def on_cpu(launch, plain):
        return lambda x, *a: (launch if x.device.type == "cpu" else plain)(
            x, *a)

    PA._run = on_cpu(paged, PA._run)
    RQ._run = on_cpu(RQ._launch, RQ._run)
    G._run = on_cpu(gemm, G._run)
    FA.flash_attention = flash


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    what = sys.argv[1] if len(sys.argv) > 1 else "build"
    if what == "build":
        for n, p in build().items():
            print(n, p)
    elif what == "smoke":
        sys.exit(smoke())
    else:
        sys.exit(f"usage: {sys.argv[0]} build|smoke")
