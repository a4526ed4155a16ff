"""Every configuration states its published widths, cut and assumptions;
every cell resolves by name to its files; a cell made only of new files
and entries loads."""
import json
import shutil

import pytest

from pbench import cells

# the published config.json values (keys as published)
PUBLISHED = {
    "gpt2-large": {"n_embd": 1280, "n_layer": 36, "n_head": 20,
                   "vocab_size": 50257, "n_positions": 1024,
                   "layer_norm_epsilon": 1e-05, "tie_word_embeddings": True,
                   "activation_function": "gelu_new"},
    "qwen2.5-14b": {"hidden_size": 5120, "intermediate_size": 13824,
                    "num_attention_heads": 40, "num_key_value_heads": 8,
                    "num_hidden_layers": 48, "vocab_size": 152064,
                    "max_position_embeddings": 131072, "rope_theta": 1e6,
                    "tie_word_embeddings": False, "hidden_act": "silu"},
}
# published key -> the port's field it sets
PORT_KEYS = {"n_embd": "d_model", "n_layer": "n_layers", "n_head": "n_heads",
             "hidden_size": "d_model", "intermediate_size": "d_ff",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "num_hidden_layers": "n_layers", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "layer_norm_epsilon": "norm_eps",
             "rms_norm_eps": "norm_eps",
             "tie_word_embeddings": "tie_embeddings"}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_widths_are_published(name):
    c = cells.config(name)
    assert isinstance(c["reduced"], list) and isinstance(c["assumed"], list)
    assert c["assumed"] and c["source"].startswith("https://")
    for key, value in PUBLISHED[name].items():
        if key in c["reduced"]:
            assert c[key] != value
        else:
            assert c[key] == value, key
    for key, field in PORT_KEYS.items():
        if key in c:
            assert c["port"][field] == c[key], key
    if name == "gpt2-large":
        assert c["port"]["d_ff"] == 4 * c["n_embd"]
    assert c["port"]["d_model"] % c["port"]["n_heads"] == 0


def test_every_cell_resolves():
    b = cells.benchmark()
    names = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        c = cells.cell(w["name"])
        assert w["config"] in names
        assert (cells.BENCH / "limits" / f"{w['name']}.json").exists()
        assert c["mix"]["serving"]["max_batch"] > 0
        for metric in c["per_layer"]:
            assert callable(cells.reader(metric["name"]))
    for c in b["configs"]:
        assert (cells.ROOT / c["file"]).exists()
        assert c["reduced"] == cells.config(c["name"])["reduced"]


def test_a_cell_of_new_files_loads(tmp_path):
    shutil.copytree(cells.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = cells.benchmark()
    bench = tmp_path / "perfbench"
    cfg = json.loads((bench / "configs" / "gpt2-large.json").read_text())
    (bench / "configs" / "gpt2-medium.json").write_text(json.dumps(
        {**cfg, "n_embd": 1024, "n_layer": 24, "n_head": 16,
         "port": {**cfg["port"], "d_model": 1024, "n_layers": 24,
                  "n_heads": 16, "n_kv_heads": 16, "d_ff": 4096}}))
    mix = json.loads((bench / "traffic" / "chat.json").read_text())
    (bench / "traffic" / "burst.json").write_text(json.dumps(mix))
    (bench / "limits" / "gpt2-medium.burst.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 1.0}}))
    (bench / "metrics" / "burst_tokens.py").write_text(
        "def read(records):\n    return 1.0\n")
    b["configs"].append({"name": "gpt2-medium", "source": "x",
                         "file": "perfbench/configs/gpt2-medium.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "gpt2-medium.burst", "config": "gpt2-medium",
                           "traffic": "burst", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "burst_tokens", "unit": "tokens",
                           "better": "higher", "source": "program_counter",
                           "layer": "scheduler", "moves": "itl_p95_ms",
                           "workloads": ["gpt2-medium.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = cells.cell("gpt2-medium.burst", tmp_path)
    assert c["config"]["port"]["d_model"] == 1024
    assert "burst_tokens" in cells.metric_names(c["per_layer"])
    assert cells.reader("burst_tokens", bench)({}) == 1.0


def test_benchmark_file_keeps_the_contract():
    b = cells.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            cell = cells.cell(w)
            assert m["moves"] in cells.metric_names(cell["end_to_end"])
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
