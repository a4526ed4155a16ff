"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  Prints the
run's comparisons as the last lines of standard error and one JSON object
as the last line of standard output; exits non-zero, printing no result,
without a card, or when the process has loaded JAX or the JAX package.
``--control w4,bf16,tf32`` also puts each named reading of the reference
(with int4 weights, the control; with bfloat16 attention and LM head;
with TF32 matmuls) in the program's place after the comparison and
judges it by the same limits: the line's ``correct`` is then theirs, and
``perfbench/limits/<cell>.json`` records what they read.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host thread that drives the card is
# the one that counts, and a pool of idle workers only contends with it
os.environ.setdefault("OMP_NUM_THREADS", "1")
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="comma-separated controls to judge after the run")
    args = ap.parse_args(argv)

    import torch
    from pbench import cells, serve

    torch.set_num_threads(1)
    need = cells.cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed & ((1 << 63) - 1)
    controls = [c for c in args.control.split(",") if c]
    unknown = sorted(set(controls) - set(serve.CONTROLS))
    if unknown:
        print(f"unknown controls {unknown}; known: {sorted(serve.CONTROLS)}",
              file=sys.stderr)
        return 2
    out = serve.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_PROCESS,
                         controls=controls)
    found = serve.forbidden_modules()
    if found:
        print("loaded in this process, which the benchmark forbids: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
