"""A cell of a new architecture takes the checks that every cell of the
benchmark takes (``test_perfbench_run.py``): the toy (``archs_windowed.py``)
joins a copy of the benchmark as new files and entries only, with its CPU
widths under its configuration's ``"small"`` and none in ``SMALL``, and
shows a correct run, a traced run whose readers read or return nothing,
the W4 control not correct and each planted fault not correct.  A run
without overrides serves the configuration's ``port`` as it stands:
``small`` is for the CPU tests alone."""
import functools

import pytest

from conftest import SMALL, TOY, TOY_CELL, small_config, toy_bench
from pbench import cells, serve
from test_perfbench_run import (FAULTS, a_control_not_correct, a_correct_run,
                                a_fault_not_correct,
                                a_reader_reads_or_returns_nothing, a_traced_run)

# the copy names the toy's cell in every per-layer metric's workloads
METRICS = [m["name"] for m in cells.benchmark()["per_layer"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_bench(tmp_path_factory.mktemp("toy"), TOY.read_text())


@pytest.fixture
def run(small_run, root):
    return functools.partial(small_run, root=root)


def test_the_toy_takes_its_widths_from_its_config(root):
    c = cells.cell(TOY_CELL, root)
    assert c["entry"]["config"] not in SMALL
    assert small_config(c["config"]) == c["config"]["small"]
    assert cells.metric_names(c["per_layer"]) == METRICS


def test_a_run_of_the_toy_cell(run, root):
    a_correct_run(run, TOY_CELL, root)


def test_a_traced_run_of_the_toy_cell(run, root):
    a_traced_run(run, TOY_CELL, root)


def test_the_control_is_not_correct_on_the_toy_cell(run):
    a_control_not_correct(run, TOY_CELL)


_TRACED = {}


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_on_the_toy_cell(run, root, metric):
    a_reader_reads_or_returns_nothing(run, TOY_CELL, metric, _TRACED, root)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_on_the_toy_cell_is_not_correct(run, monkeypatch, fault):
    a_fault_not_correct(run, TOY_CELL, monkeypatch, fault)


class _Served(Exception):
    pass


def test_without_overrides_the_port_is_served_as_it_stands(root,
                                                           monkeypatch):
    got = {}

    def setup_engine(m, *a, **k):
        got["m"] = m
        raise _Served
    monkeypatch.setattr(serve, "setup_engine", setup_engine)
    with pytest.raises(_Served):
        serve.run_cell(TOY_CELL, 123456789012, 1.0, False, device="cpu",
                       root=root, log=lambda *a, **k: None)
    c = cells.cell(TOY_CELL, root)["config"]
    assert got["m"] == c["port"]
    assert all(got["m"][k] != v for k, v in c["small"].items())
