"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference launcher (``repro.launch.serve``).

Its flags are the reference's plus ``--device``.  The plumbing tests stub
the engine, the quantizer and ``init_params`` at the launcher's module
seam, as ``tests/test_launch_serve.py`` does for the reference, so no
model compute runs; they cover the refusals (``--tp`` > 1, which the port
does not serve, among them) and the observability flags' plumbing.  One
real ``--device cpu`` run per backend serves the reduced gpt2, writes its
``--json-out`` report and a ``--save-artifact`` bundle that the reference
loads; one more runs ``--trace-out`` and ``--obs`` and checks the trace
file and the quality snapshot it writes.
"""
import json
import re

import pytest
import torch

from repro.launch import serve as JL
from repro.quantize import QuantArtifact as JQuantArtifact
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import corpus
from repro_torch.launch import serve as L


def _flags(main, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    usage = capsys.readouterr().out.split("\n\n")[0]    # the usage block
    return set(re.findall(r"(?<=\[)--[a-z][a-z-]*", usage))


def test_flag_set_is_the_reference_launchers_plus_device(capsys):
    ref = _flags(JL.main, capsys)
    assert {"--quant", "--backend", "--kv-mode", "--spec-mode", "--tp",
            "--json-out", "--pack-target"} <= ref
    assert _flags(L.main, capsys) == ref | {"--device"}


class _StubMetrics:
    registry = None

    def report(self):
        # every key the launcher's summary line reads
        return {k: 0.0 for k in (
            "tokens_per_sec", "decode_steps", "decode_batch_mean",
            "prefills", "prefill_chunks", "prefill_steps",
            "prefill_multi_steps", "prefill_batch_mean",
            "prefill_resumes", "interleaved_steps",
            "decode_stall_steps", "ttft_ms_mean", "pool_occupancy_mean",
            "pool_occupancy_peak", "fragmentation_mean", "cache_bytes",
            "kv_read_savings", "kv_bytes_read", "kv_bytes_read_dense",
            "prefix_hits", "cow_copies", "spec_verify_steps",
            "spec_proposed", "spec_accepted", "spec_acceptance",
            "decode_steps_saved")}


class _StubPool:
    mode = "stub"


class _StubEngine:
    """Captures constructor args; generate() marks requests done."""
    calls = []

    def __init__(self, cfg, params, **kw):
        self.cfg, self.params, self.kw = cfg, params, kw
        self.metrics, self.pool = _StubMetrics(), _StubPool()
        _StubEngine.calls.append(self)

    def generate(self, reqs, arrivals=None):
        for r in reqs:
            r.done = True
        return reqs

    @staticmethod
    def text(req):
        return ""


@pytest.fixture
def stubbed(monkeypatch):
    _StubEngine.calls = []
    captured = {"init_devices": []}

    def fake_quantize_model(cfg, params, calib, policy, **kw):
        captured["policy"] = policy
        captured["quantize_kw"] = kw
        captured["calib"] = calib
        return "ARTIFACT"

    def fake_init_params(cfg, seed=0, device="cuda"):
        captured["init_devices"].append(device)
        return {"params": cfg.name}

    text = corpus(300)          # a short corpus: calibration never runs
    monkeypatch.setattr(L, "TokenPipeline", lambda cfg: TokenPipeline(cfg, text))
    monkeypatch.setattr(L, "ServeEngine", _StubEngine)
    monkeypatch.setattr(L, "quantize_model", fake_quantize_model)
    monkeypatch.setattr(L.T, "init_params", fake_init_params)
    return captured


def _engine(argv):
    assert L.main(argv) == 0
    assert len(_StubEngine.calls) == 1
    return _StubEngine.calls[0]


def test_defaults_reach_engine_on_the_card(stubbed):
    eng = _engine(["--quant", "fp"])
    kw = eng.kw
    assert kw["max_batch"] == 2 and kw["s_max"] == 128
    assert kw["kv_mode"] is None            # auto
    assert kw["page_size"] == 16 and kw["n_pages"] is None
    assert kw["prefill_chunk"] == 32
    assert kw["prefill_slots"] == 2 and kw["prefill_aging"] == 1.0
    assert kw["cache_dtype"] == torch.bfloat16
    assert kw["spec_mode"] == "off" and kw["spec_k"] == 4
    assert kw["device"] == torch.device("cuda")
    assert stubbed["init_devices"] == [torch.device("cuda")]
    assert eng.params == {"params": "gpt2-small"}   # fp path: raw params
    assert eng.cfg.n_layers == 2                    # the reduced config


def test_pool_and_spec_flags_reach_engine_unmangled(stubbed):
    eng = _engine(
        ["--quant", "fp", "--kv-mode", "int8", "--page-size", "4",
         "--n-pages", "99", "--prefill-chunk", "7", "--prefill-slots", "3",
         "--prefill-aging", "0.5", "--max-batch", "5", "--s-max", "256",
         "--spec-mode", "ngram", "--spec-k", "6", "--device", "cpu",
         "--arch", "qwen2-0.5b"])
    kw = eng.kw
    assert (kw["kv_mode"], kw["page_size"], kw["n_pages"]) == ("int8", 4, 99)
    assert (kw["prefill_chunk"], kw["prefill_slots"], kw["prefill_aging"]) == (7, 3, 0.5)
    assert (kw["max_batch"], kw["s_max"]) == (5, 256)
    assert (kw["spec_mode"], kw["spec_k"]) == ("ngram", 6)
    assert kw["device"] == torch.device("cpu")
    assert eng.cfg.name == "qwen2-0.5b"


def test_quantized_path_passes_artifact_backend_and_device(stubbed):
    eng = _engine(["--quant", "muxq", "--backend", "fused", "--kv-mode", "int4",
                   "--device", "cpu"])
    assert eng.params == "ARTIFACT"         # the artifact IS the params arg
    assert eng.kw["kv_mode"] == "int4"
    spec = stubbed["policy"].resolve("layer0/mlp_up")
    assert (spec.method, spec.backend, spec.weight_granularity) == (
        "muxq", "fused", "per_channel")     # the fused packing contract
    assert (spec.act_granularity, spec.outlier_mode) == ("per_token", "static")
    assert stubbed["quantize_kw"] == {"pack_target": "both",
                                      "device": torch.device("cpu")}
    # two TokenPipeline batches of 2 x 64 tokens, the reference's calibration
    assert [b["tokens"].shape for b in stubbed["calib"]] == [(2, 64), (2, 64)]


@pytest.mark.parametrize("quant", ["naive", "smoothquant", "llm_int8"])
def test_fake_backend_policy(stubbed, quant):
    _engine(["--quant", quant, "--device", "cpu"])
    spec = stubbed["policy"].resolve("layer1/attn_qkv")
    assert spec.method == quant and spec.backend == "fake"


def test_pack_target_flag_reaches_quantizer(stubbed):
    _engine(["--quant", "muxq", "--pack-target", "fused", "--backend", "fused",
             "--device", "cpu"])
    assert stubbed["quantize_kw"]["pack_target"] == "fused"


@pytest.mark.parametrize("argv,match", [
    (["--quant", "muxq", "--backend", "fused", "--pack-target", "tree"], "pack-target"),
    (["--quant", "llm_int8", "--backend", "fused"], "llm_int8"),
    (["--tp", "2"], "item 9"),
    (["--tp", "0"], "--tp"),
    (["--tp", "2", "--trace-out", "trace.json", "--obs"], "item 9"),
    (["--spec-mode", "medusa"], None),
])
def test_refusals_serve_nothing(stubbed, argv, match):
    """Flags the port cannot honour exit with a plain message before any
    model is built or served."""
    with pytest.raises(SystemExit) as e:
        L.main(argv + ["--device", "cpu"])
    if match is not None:
        assert match in str(e.value.code)
    assert not _StubEngine.calls and not stubbed["init_devices"]


def test_json_out_dumps_report_and_registry(stubbed, tmp_path):
    out = tmp_path / "sub" / "metrics.json"
    _engine(["--quant", "fp", "--device", "cpu", "--json-out", str(out)])
    doc = json.loads(out.read_text())
    assert set(doc) == {"report", "registry", "quality"}
    assert doc["registry"] == {} and doc["quality"] == {}
    assert doc["report"]["decode_steps"] == 0.0


@pytest.mark.parametrize("argv", [
    ["--quant", "smoothquant"],
    ["--quant", "muxq", "--backend", "fused", "--kv-mode", "int4",
     "--spec-mode", "ngram", "--pack-target", "fused"],
])
def test_real_cpu_run_writes_report_and_a_bundle_the_reference_loads(
        tmp_path, capsys, argv):
    report, bundle = tmp_path / "serve.json", tmp_path / "art"
    assert L.main(argv + ["--device", "cpu", "--max-new", "4", "--json-out",
                          str(report), "--save-artifact", str(bundle)]) == 0
    out = capsys.readouterr().out
    doc = json.loads(report.read_text())
    assert doc["report"]["tokens_out"] == 8
    assert doc["registry"]["tokens_out"] == 8
    art = JQuantArtifact.load(str(bundle))
    spec = art.policy.default
    assert spec.method == argv[1] and art.prequantized
    if "--backend" in argv:
        assert "kv pages [int4]" in out and "spec[ngram]" in out
        assert spec.backend == "fused" and art.meta["pack_target"] == "fused"
        assert len(art.kernel_buffers) == art.meta["n_fused_sites"] == 8
        assert art.kv_calib and art.scan_qparams
    else:
        assert "kv pages [int8]" in out
        assert len(art.smooth_factors) == 8 and not art.kernel_buffers


def test_trace_and_obs_flags_reach_engine(stubbed, tmp_path, monkeypatch):
    """--trace-out hands the engine a TraceRecorder and writes its Chrome
    trace; --obs hands it a QualityObserver, installs it on the activation
    seam while the model is quantized and served, and uninstalls it after."""
    from repro_torch.kernels import dispatch
    from repro_torch.obs.quality import QualityObserver
    from repro_torch.obs.trace import TraceRecorder, chrome_errors

    seen = {}

    def fake_quantize_model(cfg, params, calib, policy, **kw):
        seen["installed"] = dispatch.quality_observer()
        return "ARTIFACT"

    monkeypatch.setattr(L, "quantize_model", fake_quantize_model)
    trace, out = tmp_path / "t" / "trace.json", tmp_path / "m.json"
    eng = _engine(["--quant", "muxq", "--backend", "fused", "--device", "cpu",
                   "--trace-out", str(trace), "--obs", "--json-out", str(out)])
    assert isinstance(eng.kw["recorder"], TraceRecorder)
    assert isinstance(eng.kw["quality"], QualityObserver)
    assert seen["installed"] is eng.kw["quality"]
    assert dispatch.quality_observer() is None
    assert chrome_errors(trace) == []
    doc = json.loads(out.read_text())
    assert doc["quality"] == {"pool_samples": 0, "sites": {}}
    plain = _StubEngine.calls = []
    _engine(["--quant", "fp", "--device", "cpu"])
    assert plain[0].kw["recorder"] is None and plain[0].kw["quality"] is None


def test_real_cpu_run_with_trace_and_obs(tmp_path, capsys):
    """A real traced, observed run: the Chrome trace is well formed, its
    lifecycle is, every request finished in it, and the quality snapshot
    of the int8 pool lands in --json-out."""
    from repro_torch.obs.trace import chrome_errors, lifecycle_errors

    trace, report = tmp_path / "trace.json", tmp_path / "serve.json"
    assert L.main(["--quant", "muxq", "--backend", "fused", "--device", "cpu",
                   "--max-new", "9", "--trace-out", str(trace), "--obs",
                   "--json-out", str(report)]) == 0
    out = capsys.readouterr().out
    assert "trace:" in out and "obs:" in out
    assert chrome_errors(trace) == []
    evs = json.loads(trace.read_text())["traceEvents"]
    assert sum(e["name"] == "FINISHED" for e in evs) == 2
    assert any(e["name"] == "COMPILE" for e in evs)
    doc = json.loads(report.read_text())
    q = doc["quality"]
    assert q["pool_samples"] >= 1
    assert set(q["sites"]) == {"kv/k", "kv/v"}     # no eager site in serving
    assert q["sites"]["kv/k"]["elements"] > 0
    # the events as the recorder holds them obey the lifecycle invariants
    ph = {"B": "B", "E": "E", "i": "I"}
    events = [{"kind": ph[e["ph"]], "rid": e["pid"] - 1, "name": e["name"],
               "phase": e["name"] if e["ph"] in "BE" else None,
               "step": e["args"].get("step"), "args": e["args"]}
              for e in evs if e["ph"] != "M"]
    assert lifecycle_errors(events,
                            decode_steps=doc["report"]["decode_steps"]) == []


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2.5-14b", "qwen1.5-110b",
                                  "internvl2-2b"])
def test_real_cpu_run_for_every_dense_arch(tmp_path, arch):
    """``--arch`` takes the reference's other dense decoders: the reduced
    config initializes, quantizes and serves on the fused path."""
    report = tmp_path / "serve.json"
    assert L.main(["--arch", arch, "--quant", "muxq", "--backend", "fused",
                   "--device", "cpu", "--max-new", "3", "--json-out",
                   str(report)]) == 0
    assert json.loads(report.read_text())["report"]["tokens_out"] == 6


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "dbrx-132b"])
def test_real_cpu_run_for_the_moe_archs(tmp_path, arch):
    """``--arch`` takes the reference's MoE decoders: the reduced config
    initializes, calibrates, packs its per-expert sites and serves on the
    fused path."""
    report = tmp_path / "serve.json"
    assert L.main(["--arch", arch, "--quant", "muxq", "--backend", "fused",
                   "--device", "cpu", "--max-new", "3", "--json-out",
                   str(report)]) == 0
    assert json.loads(report.read_text())["report"]["tokens_out"] == 6
