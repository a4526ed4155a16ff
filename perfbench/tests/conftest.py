"""Shared set-up of the benchmark's CPU tests: the harness and the port
on the path, the reduced sizes the end-to-end runs use, and a copy of the
benchmark that a toy architecture's cell joins."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# widths small enough for the CPU, the same families as the cells'
SMALL = {"gpt2-large": {"n_layers": 2, "d_model": 512, "n_heads": 8,
                        "n_kv_heads": 8, "d_ff": 2048, "vocab_size": 512},
         "qwen2.5-14b": {"n_layers": 2, "d_model": 320, "n_heads": 5,
                         "n_kv_heads": 1, "d_ff": 1280, "vocab_size": 512}}


def small_mix(kv_mode: str, documents: bool) -> dict:
    mix = {"serving": {"max_batch": 6, "s_max": 256, "kv_mode": kv_mode,
                       "page_size": 16, "prefill_chunk": 32,
                       "prefill_slots": 2, "prefix_sharing": True},
           "prompt_tokens": {"dist": "uniform", "min": 8, "max": 60},
           "output_tokens": {"dist": "uniform", "min": 4, "max": 12},
           "rehearsal": {"rate_per_step": 0.4, "warmup_steps": 10,
                         "start_steps": 3}}
    if documents:
        mix["documents"] = {"count": 2, "tokens": 96}
        mix["prompt_tokens"] = {"dist": "uniform", "min": 4, "max": 12}
    return mix


# the toy architecture of the tests, and the cell it brings to a copy
TOY = Path(__file__).resolve().parent / "archs_windowed.py"
TOY_CELL = "toy-windowed.prefill"


def toy_bench(tmp_path: Path, toy_source: str) -> Path:
    """A copy of the benchmark with the toy architecture's cell added as
    new files and entries only: its configuration carries ``arch`` and
    its own CPU widths (``small``), and each per-layer metric names the
    cell among its ``workloads``.  Returns the copy's root."""
    from pbench import cells

    bench = tmp_path / "perfbench"
    shutil.copytree(cells.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "archs").mkdir(exist_ok=True)
    (bench / "archs" / "windowed.py").write_text(toy_source)
    cfg = json.loads((bench / "configs" / "qwen2.5-14b.json").read_text())
    cfg["arch"] = "windowed"
    cfg["port"] = {**cfg["port"], "block_pattern": ["local", "global"],
                   "window_size": 16}
    cfg["small"] = {"n_layers": 2, "d_model": 320, "n_heads": 5,
                    "n_kv_heads": 1, "d_ff": 1280, "vocab_size": 512}
    (bench / "configs" / "toy-windowed.json").write_text(json.dumps(cfg))
    # the toy reads 0.0 and 0.0 on the CPU over 8 seeds, and without its
    # window 5.21-6.00 and 1.66-1.95; qwen2.5-14b.prefill's limits lie between
    (bench / "limits" / f"{TOY_CELL}.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 2.6}, "mean_logit_gap": {"limit": 0.55}}))
    b = cells.benchmark()
    b["configs"].append({"name": "toy-windowed", "source": "x",
                         "file": "perfbench/configs/toy-windowed.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": TOY_CELL, "config": "toy-windowed",
                           "traffic": "prefill", "chips": 1, "why": "x"})
    for m in b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TOY_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path


def small_config(config: dict) -> dict:
    """The CPU widths of a configuration: its own top-level ``"small"``
    (``port`` keys merged over ``port``) where it has one, else ``SMALL``."""
    return config["small"] if "small" in config \
        else SMALL[config["port"]["name"]]


@pytest.fixture
def small_run():
    """run_cell(cell, ...) on the CPU at reduced widths; ``root`` is the
    directory that holds the ``BENCHMARK.json`` of the cell."""
    import torch

    from pbench import cells, serve

    def run(cell, seed=123456789012, seconds=4.0, trace=False, controls=(),
            kv_mode=None, documents=None, root=cells.ROOT):
        c = cells.cell(cell, root)
        mix = small_mix(kv_mode or c["mix"]["serving"]["kv_mode"],
                        "documents" in c["mix"] if documents is None
                        else documents)
        over = {"config": small_config(c["config"]), "mix": mix,
                "steps_per_s": 5000}
        # one thread, as perfbench/run.py sets it: on a loaded host a pool
        # of threads slows the eager steps until no request finishes
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return serve.run_cell(cell, seed, seconds, trace, device="cpu",
                                  root=root, overrides=over, controls=controls,
                                  log=lambda *a, **k: None)
        finally:
            torch.set_num_threads(threads)
    return run
