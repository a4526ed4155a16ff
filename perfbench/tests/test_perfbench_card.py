"""On the card: one short run of the first cell through the benchmark's
command.  Skips without a CUDA device."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from pbench import cells

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_one_run_on_the_card(card):
    cell = cells.benchmark()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          cell, "--seed", "2147483659", "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
