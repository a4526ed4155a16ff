"""Find a cell's pieces by name: ``BENCHMARK.json``'s entry, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  Nothing here knows any cell: a cell made of
new files and entries loads without an edit."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config(name: str, bench: Path = BENCH) -> Dict:
    c = json.loads((bench / "configs" / f"{name}.json").read_text())
    c["port"]["name"] = name
    return c


def mix(name: str, bench: Path = BENCH) -> Dict:
    t = json.loads((bench / "traffic" / f"{name}.json").read_text())
    t["name"] = name
    return t


def reader(metric: str, bench: Path = BENCH) -> Callable:
    """``metrics/<metric>.py``'s ``read(records)``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "pbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(name: str, root: Path = ROOT) -> Dict:
    """The cell's entry with its configuration, mix and metric lists."""
    b = benchmark(root)
    entry = next((w for w in b["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in b["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {"entry": entry, "config": config(entry["config"], root / "perfbench"),
            "mix": mix(entry["traffic"], root / "perfbench"),
            "end_to_end": [m for m in b["end_to_end"] if applies(m)],
            "per_layer": [m for m in b["per_layer"] if applies(m)],
            "run_seconds": b["run_seconds"]}


def metric_names(metrics: List[Dict]) -> List[str]:
    return [m["name"] for m in metrics]
