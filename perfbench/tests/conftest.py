"""Shared set-up of the benchmark's CPU tests: the harness and the port
on the path, and the reduced sizes the end-to-end runs use."""
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


@pytest.fixture
def small_run():
    """run_cell(cell, ...) on the CPU at reduced widths."""
    import torch

    from pbench import cells, serve

    def run(cell, seed=123456789012, seconds=4.0, trace=False, controls=(),
            kv_mode=None, documents=None):
        c = cells.cell(cell)
        mix = small_mix(kv_mode or c["mix"]["serving"]["kv_mode"],
                        "documents" in c["mix"] if documents is None
                        else documents)
        over = {"config": SMALL[c["entry"]["config"]], "mix": mix,
                "steps_per_s": 5000}
        # one thread, as perfbench/run.py sets it: on a loaded host a pool
        # of threads slows the eager steps until no request finishes
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return serve.run_cell(cell, seed, seconds, trace, device="cpu",
                                  overrides=over, controls=controls,
                                  log=lambda *a, **k: None)
        finally:
            torch.set_num_threads(threads)
    return run
