"""A configuration brings its architecture as a new file: without an
``arch`` key it resolves to the dense decoder's own code; with one, a
cell made only of new files (the toy ``archs_windowed.py`` copied in as
``archs/windowed.py``) runs and is judged by that file's reference.  The
resolution holds on the benchmark itself and on such a copy.  The
run's counters are every counter the program registers, and the port's
dict becomes the program's ``ModelConfig``."""
from pathlib import Path

import pytest

from conftest import SMALL, TOY, TOY_CELL as CELL, toy_bench
from pbench import cells, reference, serve, weights

SEEDS = (123456789012, 4052739537881, 2718281828459)


@pytest.fixture(params=["benchmark", "toy copy"])
def root(request, tmp_path):
    """The benchmark itself, and a copy that the toy's cell joins."""
    if request.param == "benchmark":
        return cells.ROOT
    return toy_bench(tmp_path, TOY.read_text())


def _configs(root: Path, with_arch: bool):
    bench = root / "perfbench"
    found = [cells.config(c["name"], bench)
             for c in cells.benchmark(root)["configs"]]
    return [c for c in found if ("arch" in c) == with_arch]


def test_a_config_without_arch_resolves_to_the_dense_code(root):
    for c in _configs(root, False):
        a = cells.arch(c, root / "perfbench")
        assert a.tree is weights.tree
        assert a.Reference is reference.Reference


def test_a_config_with_arch_resolves_to_its_own_file(root):
    bench = root / "perfbench"
    found = _configs(root, True)
    assert found or root == cells.ROOT
    for c in found:
        a = cells.arch(c, bench)
        # the module made from archs/<arch>.py, whose reference is its own
        # (the toy's weights are the dense decoder's: its tree may be too)
        assert Path(a.__file__) == bench / "archs" / f"{c['arch']}.py"
        assert callable(a.tree)
        assert a.Reference is not reference.Reference


@pytest.mark.parametrize("seed", SEEDS)
def test_a_cell_of_a_new_architecture_runs_correct(small_run, tmp_path, seed):
    out = small_run(CELL, seed, root=toy_bench(tmp_path, TOY.read_text()))
    assert out["correct"] is True and out["attempted"] > 0
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("seed", SEEDS)
def test_its_reference_without_the_window_is_not_correct(small_run, tmp_path,
                                                         seed):
    # the planted fault: the toy's reference attends to every position on
    # the local layers too, so the reference that judges the run is shown
    # to be the architecture's own
    src = TOY.read_text()
    line = 'WINDOWED = ("local",)'
    assert line in src
    out = small_run(CELL, seed, root=toy_bench(
        tmp_path, src.replace(line, "WINDOWED = ()")))
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
