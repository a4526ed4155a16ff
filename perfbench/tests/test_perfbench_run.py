"""Whole runs on the CPU at reduced widths, through the port's plain
kernel versions: each mix gives a result of the contract's shape; the
controls (the reference with int4 weights, and with bfloat16 attention
and head) and each fault that a serving cell can have, planted under the
timed path, come out not correct.

The per-cell checks are functions of ``(run, cell)``, where ``run`` is
``small_run`` or one bound to another benchmark's root, so that a cell of
a copy of the benchmark is held to the same checks
(``test_perfbench_toy_cell.py``)."""
import json
import math

import pytest
import torch

from pbench import cells

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def _shape(out, cell, trace, root=cells.ROOT):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    c = cells.cell(cell, root)
    want = c["per_layer"] if trace else c["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    for name, v in out["metrics"].items():
        assert units[name] == v["unit"] and math.isfinite(v["value"])
    if not trace:
        assert set(out["metrics"]) == set(units)
    json.loads(json.dumps(out))


def a_correct_run(run, cell, root=cells.ROOT):
    _correct_run(run(cell), cell, root)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_each_cell(small_run, cell):
    a_correct_run(small_run, cell)


def test_a_run_on_int4_pages_with_shared_documents(small_run):
    # the generator's documents and the reference's int4 pages, which a
    # documents mix on int4 pages would use
    cell = "qwen2.5-14b.prefill"
    out = small_run(cell, kv_mode="int4", documents=True)
    _correct_run(out, cell)


def _correct_run(out, cell, root=cells.ROOT):
    _shape(out, cell, False, root)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert "mean_logit_gap" in out["checks"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def a_traced_run(run, cell, root=cells.ROOT):
    out = run(cell, trace=True)
    _shape(out, cell, True, root)
    assert out["correct"] is True
    assert out["metrics"], "no per-layer metric found anything to read"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run(small_run, cell):
    a_traced_run(small_run, cell)


def a_control_not_correct(run, cell):
    out = run(cell, controls=("w4",))
    assert out["program_correct"] is True
    assert out["correct"] is False
    judged = out["controls"]["w4"]
    assert judged["correct"] is False
    assert any(c["value"] > c["limit"] for c in judged["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(small_run, cell):
    a_control_not_correct(small_run, cell)


def test_the_float_readings_are_judged_too(small_run):
    # bfloat16 attention and head, and TF32, go through the same verdict;
    # they are readings, which the cells' limits do not catch (PERF.md)
    out = small_run(CELLS[0], controls=("bf16", "tf32"))
    for k in ("bf16", "tf32"):
        judged = out["controls"][k]
        assert isinstance(judged["correct"], bool)
        assert set(judged["checks"]) == set(out["checks"])
        assert math.isfinite(judged["gap"]) and judged["tokens"] > 0


_TRACED = {}


def a_reader_reads_or_returns_nothing(run, cell, metric, traced=_TRACED,
                                      root=cells.ROOT):
    """The metric's reading in one small traced run a cell, kept in
    ``traced`` and shared by the cell's readers' cases, or None."""
    # a reader that finds nothing to read (no device profile on the CPU)
    # returns nothing, and never a 0 for a share
    if cell not in traced:
        traced[cell] = run(cell, trace=True)
    source = next(m["source"] for m in cells.cell(cell, root)["per_layer"]
                  if m["name"] == metric)
    got = traced[cell]["metrics"].get(metric)
    if source == "device_trace":
        assert got is None
    elif got is not None:
        assert math.isfinite(got["value"]) and got["value"] > 0
    return got


@pytest.mark.parametrize("cell,metric", [
    (c, m["name"]) for c in CELLS for m in cells.cell(c)["per_layer"]])
def test_each_reader_reads_or_returns_nothing(small_run, cell, metric):
    a_reader_reads_or_returns_nothing(small_run, cell, metric)


def test_longest_step_is_the_widest_gap_in_the_window():
    from types import SimpleNamespace

    from pbench import serve
    st = SimpleNamespace(steps=[{"wall": w} for w in (0.5, 1.2, 1.4, 2.9, 3.5)])
    # the window opens at 1.0: gaps 0.2, 0.2, 1.5; the step at 3.5 is past it
    assert serve.longest_step_ms(st, 1.0, 3.0) == pytest.approx(1500.0)
    assert math.isnan(serve.longest_step_ms(st, 3.6, 4.0))


STEPS = ("prefill_chunk_paged", "decode_step_paged")


def _state_unchanged(monkeypatch):
    """Each paged step leaves the pool as it found it: no K/V lands."""
    from repro_torch.models import transformer as T
    for name in STEPS:
        orig = getattr(T, name)

        def step(cfg, params, tokens, kv, *a, orig=orig, **k):
            saved = {n: t.clone() for n, t in kv.items()}
            logits, kv = orig(cfg, params, tokens, kv, *a, **k)
            for n, t in kv.items():
                t.copy_(saved[n])
            return logits, kv
        monkeypatch.setattr(T, name, step)


def _half_left_out(monkeypatch):
    """Each paged step computes the first half of the slots' rows and
    hands the second half copies of them."""
    from repro_torch.models import transformer as T
    for name in STEPS:
        orig = getattr(T, name)

        def step(*a, orig=orig, **k):
            logits, kv = orig(*a, **k)
            n = logits.shape[0]
            logits[n // 2:] = logits[: n - n // 2]
            return logits, kv
        monkeypatch.setattr(T, name, step)


def _token_altered(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine._decode_pool

    def decode(self, *a, **k):
        nxt, kv = orig(self, *a, **k)
        return (nxt + 1) % self.cfg.vocab_size, kv
    monkeypatch.setattr(ServeEngine, "_decode_pool", decode)


FAULTS = [_state_unchanged, _half_left_out, _token_altered]


def a_fault_not_correct(run, cell, monkeypatch, fault):
    fault(monkeypatch)
    out = run(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(small_run, monkeypatch,
                                                     cell, fault):
    a_fault_not_correct(small_run, cell, monkeypatch, fault)


def test_cpu_only_machine_refuses(monkeypatch, capsys):
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
