"""Find a cell's pieces by name: ``BENCHMARK.json``'s entry, its
configuration (``configs/<config>.json``), the architecture that makes
its weights and reference (``archs/<arch>.py``), its traffic mix
(``traffic/<mix>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  Nothing here knows any cell: a cell made of
new files and entries loads without an edit."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Union

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


def _load(kind: str, name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"pbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Path = BENCH) -> Callable:
    """``metrics/<metric>.py``'s ``read(records)``."""
    return _load("metric", metric, bench / "metrics" / f"{metric}.py").read


def arch(config: Dict, bench: Path = BENCH) -> Union[ModuleType, SimpleNamespace]:
    """The code that makes a configuration's weights and its plain
    reference: ``archs/<name>.py`` where the configuration's file has a
    top-level ``"arch": "<name>"``, else the dense pre-norm decoder of
    ``pbench.weights`` and ``pbench.reference``.

    An architecture file provides

    * ``tree(m, seed, device)``: the program's float32 parameters in the
      port's tree layout, made on ``device`` from the seed (``m`` is the
      configuration's ``port`` dict);
    * ``Reference(m, seed, kv_mode, device)``, with
      ``calibrate(batches)``, which works out again from the same seed and
      the [b, s] token batches everything the program's set-up derived
      (outlier masks, KV redistribution), and ``logits(seqs, first,
      weight_bits=8, tf32=False, float_dtype=torch.float32)``, which
      returns each sequence's logits [len(seq) - first, vocab] at
      positions ``first`` onwards, its int8 sites at ``weight_bits``
      (4 is the control) and its float parts in ``float_dtype``, with TF32
      matmuls only where ``tf32``.

    It imports nothing of the program and nothing of JAX, and may import
    ``pbench.weights`` and ``pbench.reference`` to share their pieces
    (``derive``, ``hot_channels``, ``norm``, ``rope``, ``muxq_site``,
    ``kv_int8``, ``kv_int4``, ...)."""
    name = config.get("arch")
    if name is None:
        from pbench import reference, weights
        return SimpleNamespace(tree=weights.tree, Reference=reference.Reference)
    return _load("arch", name, bench / "archs" / f"{name}.py")


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
