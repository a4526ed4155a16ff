"""A configuration brings its architecture as a new file: without an
``arch`` key it resolves to the dense decoder's own code; with one, a
cell made only of new files (the toy ``archs_windowed.py`` copied in as
``archs/windowed.py``) runs and is judged by that file's reference.  The
run's counters are every counter the program registers, and the port's
dict becomes the program's ``ModelConfig``."""
import json
import shutil
from pathlib import Path

import pytest
import torch

from conftest import SMALL, small_mix
from pbench import cells, reference, serve, weights

TOY = Path(__file__).resolve().parent / "archs_windowed.py"
CELL = "toy-windowed.prefill"
SEEDS = (123456789012, 4052739537881, 2718281828459)


def test_a_config_without_arch_resolves_to_the_dense_code():
    for c in cells.benchmark()["configs"]:
        a = cells.arch(cells.config(c["name"]))
        assert a.tree is weights.tree
        assert a.Reference is reference.Reference


def _toy_bench(tmp_path, toy_source: str) -> Path:
    """A copy of the benchmark with the toy architecture's cell added as
    new files and entries only."""
    bench = tmp_path / "perfbench"
    shutil.copytree(cells.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "archs").mkdir(exist_ok=True)
    (bench / "archs" / "windowed.py").write_text(toy_source)
    cfg = json.loads((bench / "configs" / "qwen2.5-14b.json").read_text())
    cfg["arch"] = "windowed"
    cfg["port"] = {**cfg["port"], "block_pattern": ["local", "global"],
                   "window_size": 16}
    (bench / "configs" / "toy-windowed.json").write_text(json.dumps(cfg))
    # the toy reads 0.0 and 0.0 on the CPU over 8 seeds, and without its
    # window 5.21-6.00 and 1.66-1.95; qwen2.5-14b.prefill's limits lie between
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 2.6}, "mean_logit_gap": {"limit": 0.55}}))
    b = cells.benchmark()
    b["configs"].append({"name": "toy-windowed", "source": "x",
                         "file": "perfbench/configs/toy-windowed.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": CELL, "config": "toy-windowed",
                           "traffic": "prefill", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path


def _run(root: Path, seed: int):
    over = {"config": SMALL["qwen2.5-14b"], "mix": small_mix("int8", False),
            "steps_per_s": 5000}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return serve.run_cell(CELL, seed, 4.0, False, device="cpu",
                              root=root, overrides=over,
                              log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_cell_of_a_new_architecture_runs_correct(tmp_path, seed):
    out = _run(_toy_bench(tmp_path, TOY.read_text()), seed)
    assert out["correct"] is True and out["attempted"] > 0
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("seed", SEEDS)
def test_its_reference_without_the_window_is_not_correct(tmp_path, seed):
    # the planted fault: the toy's reference attends to every position on
    # the local layers too, so the reference that judges the run is shown
    # to be the architecture's own
    src = TOY.read_text()
    line = 'WINDOWED = ("local",)'
    assert line in src
    out = _run(_toy_bench(tmp_path, src.replace(line, "WINDOWED = ()")), seed)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


# the counters the harness snapshotted by name before it took every one
OLD_COUNTERS = ("decode_steps", "decode_slot_steps", "prefill_steps",
                "prefill_chunk_tokens", "prefix_hits", "preemptions",
                "tokens_out", "completed")


def test_the_window_counters_are_every_registered_counter(small_run,
                                                          monkeypatch):
    seen, got = [], {}
    counters = serve.counters

    def both(met):
        seen.append({k: getattr(met, k) for k in OLD_COUNTERS})
        return counters(met)

    records = serve._records

    def keep(*a, **k):
        got["records"] = records(*a, **k)
        return got["records"]
    monkeypatch.setattr(serve, "counters", both)
    monkeypatch.setattr(serve, "_records", keep)
    out = small_run("qwen2.5-14b.prefill", trace=True)
    assert out["correct"] is True
    window = got["records"]["counters"]
    assert len(seen) == 2
    for k in OLD_COUNTERS:
        assert window[k] == seen[1][k] - seen[0][k], k
    assert window["prefill_computed_tokens"] >= window["prefill_chunk_tokens"] > 0
    assert "bytes_per_token" not in window and "kv_shards" not in window
    assert not [k for k in window if k.startswith("hist/")]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_model_config_is_the_dense_one(name):
    from repro_torch.models.common import ModelConfig
    m = cells.config(name)["port"]
    want = ModelConfig(**{**m, "block_pattern": tuple(m["block_pattern"])})
    assert serve.model_config(m) == want
    many = {**m, "block_pattern": ["local", "global"]}
    assert serve.model_config(many).block_pattern == ("local", "global")
