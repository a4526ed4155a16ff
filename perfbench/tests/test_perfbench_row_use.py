"""``prefill_row_use``: the prompt tokens of the window's prefill calls
over the rows those calls computed (PR 26's ``prefill_computed_tokens``),
a share of at most 1 that reads nothing without a prefill call."""
import pytest

from pbench import cells
from test_perfbench_run import a_reader_reads_or_returns_nothing


def test_the_reader_is_the_counters_share():
    read = cells.reader("prefill_row_use")
    c = {"prefill_chunk_tokens": 1470, "prefill_computed_tokens": 1672}
    assert read({"counters": c}) == pytest.approx(1470 / 1672)
    assert read({"counters": {"prefill_chunk_tokens": 0,
                              "prefill_computed_tokens": 0}}) is None


def test_a_traced_run_reads_at_most_one(small_run):
    got = a_reader_reads_or_returns_nothing(
        small_run, "qwen2.5-14b.prefill", "prefill_row_use", {})
    assert got is not None and 0 < got["value"] <= 1
