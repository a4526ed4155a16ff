"""The readers of the scheduler's host phases on step records made by
hand: a mean over the window's steps, the profiled steps and the step
after them left out, and nothing read without ``host_ms``."""
import pytest

from pbench import cells


def _step(step, **host):
    return {"step": step, "wall": float(step), "host_ms": host}


# steps 1-2 decode only, 3 a chunk and a decode, 4-5 profiled, 6 after the
# profile, 7 a chunk and a decode
STEPS = [
    _step(1, tail=1.0, admit=0.5, pages=0.5, decode_enqueue=10.0,
          decode_readback=20.0, decode_post=2.0),
    _step(2, tail=1.0, admit=0.5, pages=0.5, decode_enqueue=12.0,
          decode_readback=22.0, decode_post=2.0),
    _step(3, tail=2.0, admit=1.0, prefill_build=3.0, prefill_enqueue=40.0,
          prefill_readback=800.0, prefill_post=1.0, pages=1.0,
          decode_enqueue=14.0, decode_readback=24.0, decode_post=2.0),
    _step(4, tail=90.0, prefill_build=90.0, prefill_enqueue=900.0,
          prefill_readback=900.0, decode_enqueue=900.0,
          decode_readback=900.0),
    _step(5, tail=90.0, decode_enqueue=900.0, decode_readback=900.0),
    _step(6, tail=90.0, prefill_enqueue=900.0, prefill_readback=900.0,
          decode_enqueue=900.0, decode_readback=900.0),
    _step(7, tail=3.0, admit=1.0, prefill_build=2.0, prefill_enqueue=60.0,
          prefill_readback=780.0, prefill_post=2.0, pages=2.0,
          decode_enqueue=16.0, decode_readback=26.0, decode_post=3.0),
]
PROFILE = {"first_step": 4, "last_step": 5}

WANT = {"host_serial_ms": (4.0 + 4.0 + 10.0 + 13.0) / 4,
        "step_enqueue_ms": (10.0 + 12.0 + 54.0 + 76.0) / 4,
        "prefill_call_ms": (840.0 + 840.0) / 2,
        "decode_call_ms": (30.0 + 34.0 + 38.0 + 42.0) / 4}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_phase_reader_means_the_window_outside_the_profile(metric):
    read = cells.reader(metric)
    records = {"steps": STEPS, "profile": PROFILE}
    assert read(records) == pytest.approx(WANT[metric])
    # the whole window when nothing was profiled
    every = {"steps": STEPS[:3], "profile": None}
    assert read(every) > 0


@pytest.mark.parametrize("metric", sorted(WANT))
def test_phase_reader_reads_nothing_without_host_phases(metric):
    read = cells.reader(metric)
    bare = [{k: v for k, v in s.items() if k != "host_ms"} for s in STEPS]
    assert read({"steps": bare, "profile": PROFILE}) is None
    assert read({"steps": [], "profile": None}) is None


def test_phase_readers_are_declared_for_the_cell():
    c = cells.cell("qwen2.5-14b.prefill")
    spans = {m["name"]: m for m in c["per_layer"]}
    for metric in WANT:
        assert spans[metric]["source"] == "program_span"
        assert spans[metric]["unit"] == "ms"
