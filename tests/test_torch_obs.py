"""The port's flight recorder and quality observers (``repro_torch.obs``)
against the reference's (``repro.obs``).

The recorder's and the checkers' cases are the reference's own
(``tests/test_obs.py``), run on the port's copies.  The serving runs give
both engines the same weights and requests, at f32 (fp pages in f32, or
the reference-written fused-MUXQ bundle on int8 pages), and hold:

  * the recorders' event lists equal in kind, rid, phase, name, step and
    args (the wall clock left out), ``COMPILE`` events included: the
    port's ``*_traces`` counters are the first use of a bucket key, the
    reference's are jit traces;
  * the streams with and without the recorder identical;
  * the quality snapshots equal in every count, and in ``amax`` within
    1e-6 relative (f32 scales; the int8 codes are bit-equal);
  * no activation observed inside the engine's three step calls.

The port runs on CPU tensors, i.e. through the kernels' plain versions.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.context import as_ctx as jas_ctx
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.core.policy import SitePolicy as JSitePolicy
from repro.kernels import dispatch as jdispatch
from repro.models import transformer as JT
from repro.obs.quality import QualityObserver as JQualityObserver
from repro.obs.trace import TraceRecorder as JTraceRecorder
from repro.quantize import quantize_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.pool import PagePool as JPagePool
from repro_torch.configs import get_config
from repro_torch.convert import as_port_params
from repro_torch.core.context import QuantCtx, as_ctx
from repro_torch.core.muxq import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.obs import trace as OT
from repro_torch.obs.quality import QualityObserver
from repro_torch.obs.trace import (NULL_RECORDER, SCHED_RID, TraceRecorder,
                                   chrome_errors, lifecycle_errors)
from repro_torch.quantize import QuantArtifact
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pool import PagePool

FUSED = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
             weight_granularity="per_channel", backend="fused")
HOT = [3, 17, 40]          # LayerNorm channels scaled x20 (calibrated outliers)
AMAX_RTOL = 1e-6           # quality amax: f32 scales times equal int codes


# ---------------------------------------------------------------------------
# trace recorder (the reference's cases, on the port's copy)
# ---------------------------------------------------------------------------

def test_module_constants_match_reference():
    from repro.obs import trace as JOT
    assert (OT.SCHED_RID, OT.PHASES, OT.TIDS, OT.SPAN_PHASES) == (
        JOT.SCHED_RID, JOT.PHASES, JOT.TIDS, JOT.SPAN_PHASES)


def test_null_recorder_is_inert():
    assert NULL_RECORDER.enabled is False
    NULL_RECORDER.begin(0, "QUEUED", 0)
    NULL_RECORDER.step_record(0, decode_ran=True)
    NULL_RECORDER.compile_event("decode", page_bucket=1)
    assert NULL_RECORDER.events == [] and NULL_RECORDER.dropped == 0


def test_recorder_spans_pair_up():
    rec = TraceRecorder()
    rec.begin(0, "QUEUED", 1)
    rec.end(0, "QUEUED", 3)
    rec.begin(0, "DECODING", 3)
    rec.end(0, "DECODING", 9, tokens=6)
    spans = rec.spans()[0]
    assert [(s["phase"], s["t0"], s["t1"]) for s in spans] == [
        ("QUEUED", 1, 3), ("DECODING", 3, 9)]
    assert spans[1]["args"]["tokens"] == 6


def test_recorder_ring_drops_oldest():
    rec = TraceRecorder(capacity=3)
    for i in range(5):
        rec.instant(0, "SCHED", "STEP", i)
    assert rec.dropped == 2
    assert [e["step"] for e in rec.events] == [2, 3, 4]
    with pytest.raises(ValueError):
        TraceRecorder(capacity=0)


def test_recorder_rejects_unknown_phase():
    rec = TraceRecorder()
    with pytest.raises(ValueError):
        rec.begin(0, "TEARDOWN", 0)


def test_export_chrome_well_formed(tmp_path):
    rec = TraceRecorder()
    rec.set_metadata(mesh_devices=1, kv_shards=1)
    rec.begin(0, "QUEUED", 0)
    rec.end(0, "QUEUED", 1)
    rec.instant(0, "DECODING", "FIRST_TOKEN", 2, ttft_steps=2)
    rec.step_record(2, decode_ran=True, slots=1)
    rec.compile_event("decode", bucket=4, traces=1)
    path = rec.export_chrome(tmp_path / "t.json")
    assert chrome_errors(path) == []
    doc = json.loads(path.read_text())
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    # pid 0 is the scheduler pseudo-request, requests start at pid 1
    assert {e["pid"] for e in evs} == {0, 1}
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"process_name", "thread_name", "process_labels"} <= names
    first = next(e for e in evs if e["name"] == "FIRST_TOKEN")
    assert first["ph"] == "i" and first["s"] == "t"
    assert first["args"]["step"] == 2   # step clock rides args
    assert doc["otherData"] == {"mesh_devices": 1, "kv_shards": 1,
                                "dropped_events": 0}


def test_chrome_errors_flags_unknown_pid_and_tid(tmp_path):
    bad = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "r"}},
        {"name": "X", "ph": "i", "pid": 2, "tid": 1, "ts": 0, "args": {}},
        {"name": "Y", "ph": "i", "pid": 1, "tid": 3, "ts": 0, "args": {}},
    ]}
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(bad))
    errs = chrome_errors(p)
    assert len(errs) == 2 and "pid 2" in errs[0] and "tid 3" in errs[1]
    p.write_text("{not json")
    assert "unreadable" in chrome_errors(p)[0]


# ---------------------------------------------------------------------------
# lifecycle invariants (synthetic sequences)
# ---------------------------------------------------------------------------

def _ev(kind, rid, phase, name, step, **args):
    return {"kind": kind, "rid": rid, "phase": phase, "name": name,
            "step": step, "wall": 0.0, "args": args}


def _well_formed(rid=0):
    return [
        _ev("I", rid, "QUEUED", "SUBMITTED", 0),
        _ev("B", rid, "QUEUED", "QUEUED", 0),
        _ev("E", rid, "QUEUED", "QUEUED", 1),
        _ev("I", rid, "QUEUED", "ADMITTED", 1),
        _ev("B", rid, "PREFILLING", "PREFILLING", 1),
        _ev("I", rid, "PREFILLING", "CHUNK", 1, tokens=8),
        _ev("E", rid, "PREFILLING", "PREFILLING", 2),
        _ev("B", rid, "DECODING", "DECODING", 2),
        _ev("I", rid, "DECODING", "FIRST_TOKEN", 2),
        _ev("I", rid, "DECODING", "FINISHED", 5),
        _ev("E", rid, "DECODING", "DECODING", 5),
    ]


def _both(events, **kw):
    """The port's checker, asserted equal to the reference's."""
    from repro.obs.trace import lifecycle_errors as jlifecycle_errors
    errs = lifecycle_errors(events, **kw)
    assert errs == jlifecycle_errors(events, **kw)
    return errs


def test_lifecycle_well_formed_passes():
    assert _both(_well_formed()) == []


def test_lifecycle_incomplete_request_skipped():
    # no FINISHED -> no invariants enforced (mid-run snapshot)
    assert _both(_well_formed()[:5]) == []


def test_lifecycle_flags_step_disorder():
    evs = _well_formed()
    evs[3]["step"] = 9              # ADMITTED after FIRST_TOKEN
    assert any("ADMITTED" in e for e in _both(evs))


def test_lifecycle_flags_open_and_nested_spans():
    evs = [e for e in _well_formed() if not
           (e["kind"] == "E" and e["phase"] == "DECODING")]
    assert any("open spans" in e for e in _both(evs))
    evs = _well_formed()
    evs.insert(2, _ev("B", 0, "QUEUED", "QUEUED", 0))
    assert any("nested" in e for e in _both(evs))


def test_lifecycle_flags_preempt_without_replay():
    evs = _well_formed()
    evs.insert(9, _ev("I", 0, "DECODING", "PREEMPTED", 4))
    assert any("PREEMPTED" in e for e in _both(evs))
    # ... but a replay re-entering PREFILLING satisfies the invariant
    evs_ok = evs[:10] + [
        _ev("E", 0, "DECODING", "DECODING", 4),
        _ev("B", 0, "PREFILLING", "PREFILLING", 6),
        _ev("E", 0, "PREFILLING", "PREFILLING", 7),
        _ev("B", 0, "DECODING", "DECODING", 7),
    ] + evs[10:]
    assert _both(evs_ok) == []


def test_lifecycle_step_record_sum():
    evs = _well_formed()
    evs += [_ev("I", SCHED_RID, "SCHED", "STEP", s, decode_ran=True)
            for s in (2, 3, 4, 5)]
    evs += [_ev("I", SCHED_RID, "SCHED", "STEP", 1, decode_ran=False)]
    assert _both(evs, decode_steps=4) == []
    assert _both(evs, decode_steps=5)


# ---------------------------------------------------------------------------
# quality observer
# ---------------------------------------------------------------------------

def test_observe_activation_counts_saturation():
    obs = QualityObserver(ratio=4.0)
    # per-token abs-max scaling: exactly the row-max elements saturate
    x = np.array([[1.0, 1.0, 1.0, 2.0, 100.0],
                  [1.0, 1.0, 1.0, 50.0, 0.5]], np.float32)
    obs.observe_activation("site", torch.from_numpy(x), qmax=127)
    st = obs.sites["site"]
    assert st.calls == 1 and st.elements == 10
    assert st.amax == 100.0
    assert st.saturated == 2        # one row-max per token row
    # channel amax = [1, 1, 1, 50, 100], median 1: channels 3 and 4 hot
    assert st.hot_channels == 2
    assert st.outlier_hit_rate == 1.0       # no mask: vacuous hits
    obs.observe_activation("site", x, qmax=127,
                           mask=torch.tensor([False] * 4 + [True]))
    assert obs.sites["site"].hot_hits == 2 + 1   # mask covers only ch 4
    assert json.dumps(obs.snapshot())


def test_observe_activation_matches_reference():
    """Random activations with planted hot channels, with and without a
    mask, at int8 and int4 ceilings, in f32 and bf16: equal snapshots."""
    rng = np.random.default_rng(3)
    obs, jobs = QualityObserver(), JQualityObserver()
    for i, qmax in enumerate((127, 7, 127)):
        x = rng.standard_normal((3, 5, 48)).astype(np.float32)
        x[..., [2, 30]] *= 25.0
        mask = np.zeros(48, bool)
        mask[[2, 9]] = True
        tx = torch.from_numpy(x)
        jx = jnp.asarray(x)
        if i == 2:                       # bf16 activations
            tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
        for m in (None, mask):
            obs.observe_activation(f"s{i}", tx, qmax=qmax, mask=m)
            jobs.observe_activation(f"s{i}", np.asarray(jx), qmax=qmax,
                                    mask=m)
    assert obs.snapshot() == jobs.snapshot()


def test_quality_observer_hooks_eager_quantctx():
    ctx = QuantCtx(QuantConfig(method="naive"), device="cpu")
    x = torch.ones(2, 8)
    w = torch.ones(8, 4)
    obs = QualityObserver()
    prev = dispatch.set_quality_observer(obs)
    try:
        ctx("site", x, w)
        assert obs.sites["site"].calls == 1
        # the serve steps' guard: nothing is observed while suspended
        with dispatch.observation_suspended():
            with dispatch.observation_suspended():
                ctx("site", x, w)
            ctx("site", x, w)
            assert dispatch.quality_observer() is None
        assert obs.sites["site"].calls == 1
        assert dispatch.quality_observer() is obs
    finally:
        dispatch.set_quality_observer(prev)
    # uninstalled again: no further accumulation
    ctx("site", x, w)
    assert obs.sites["site"].calls == 1


def _fill_pools(mode, cfg, tcfg, kv_calib=None):
    """A reference pool with one slot's 8 prefilled positions, and the
    port's pool holding the same pages, table and refcounts."""
    jpool = JPagePool(cfg, n_slots=2, s_max=16, page_size=4, mode=mode,
                      kv_calib=kv_calib)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    k = rng.normal(size=(cfg.n_layers, 8, kvh, dh)).astype(np.float32)
    k[..., 1] *= 6.0                           # one hot K channel
    v = rng.normal(size=k.shape).astype(np.float32)
    assert jpool.admit(0, 8)
    jpool.write_prefill(0, jnp.asarray(k), jnp.asarray(v))
    pool = PagePool(tcfg, n_slots=2, s_max=16, page_size=4, mode=mode,
                    kv_calib=kv_calib, device="cpu")
    assert pool.admit(0, 8)
    np.testing.assert_array_equal(pool.page_table, jpool.page_table)
    for name, a in jpool.kv.items():
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        pool.kv[name] = torch.from_numpy(a.copy()).to(pool.kv[name].dtype)
    return jpool, pool


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quality_observer_samples_pool_as_reference(mode):
    cfg = jget_config("gpt2-small", reduced=True).replace(
        n_layers=2, n_heads=2, n_kv_heads=2, d_model=32)
    tcfg = get_config("gpt2-small", reduced=True).replace(
        n_layers=2, n_heads=2, n_kv_heads=2, d_model=32)
    calib = None
    if mode == "int4":       # a calibrated redistribution on K channel 1
        km = np.zeros((cfg.n_kv_heads, cfg.head_dim), bool)
        km[:, 1] = True
        calib = {"k_mask": km, "v_mask": np.zeros_like(km),
                 "exp_factor": np.int32(2)}
    jpool, pool = _fill_pools(mode, cfg, tcfg, calib)
    np.testing.assert_array_equal(pool.live_pages(), jpool.live_pages())
    obs, jobs = QualityObserver(sample_every=4), JQualityObserver(sample_every=4)
    obs.maybe_sample_pool(pool, step=1)      # off-cycle: skipped
    assert obs.pool_samples == 0
    obs.maybe_sample_pool(pool, step=4)
    jobs.maybe_sample_pool(jpool, step=4)
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    st = snap["sites"]["kv/k"]
    assert snap["pool_samples"] == 1
    assert st["elements"] > 0 and st["clip_rate"] > 0 and st["amax"] > 0
    if mode == "int4":
        assert st["hot_channels"] > 0 and st["outlier_hit_rate"] == 1.0
    _assert_quality_equal(snap, jsnap)


def test_quality_observer_ignores_fp_pool():
    cfg = get_config("gpt2-small", reduced=True).replace(
        n_layers=1, n_heads=2, n_kv_heads=2, d_model=32)
    pool = PagePool(cfg, n_slots=1, s_max=8, page_size=4, mode="fp",
                    device="cpu")
    obs = QualityObserver()
    obs.sample_pool(pool)
    assert obs.pool_samples == 0 and obs.sites == {}


def _assert_quality_equal(snap, jsnap):
    assert snap["pool_samples"] == jsnap["pool_samples"]
    assert set(snap["sites"]) == set(jsnap["sites"])
    for name, s in snap["sites"].items():
        j = jsnap["sites"][name]
        for key in ("calls", "elements", "clip_rate", "hot_channels",
                    "outlier_hit_rate"):
            assert s[key] == j[key], (name, key, s[key], j[key])
        np.testing.assert_allclose(s["amax"], j["amax"], rtol=AMAX_RTOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# end to end: queued engine runs with the recorder on, in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_model(tmp_path_factory):
    """Reduced gpt2 with outlier channels, and the fused-MUXQ bundle the
    reference wrote for it."""
    cfg = jget_config("gpt2-small", reduced=True)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    for ln in ("ln1", "ln2"):
        params["layers"][ln]["gain"][:, HOT] *= 20.0
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
               for _ in range(2)]
    art = quantize_model(cfg, jax.tree.map(jnp.asarray, params), batches,
                         JSitePolicy.uniform(JQuantConfig(**FUSED)))
    path = tmp_path_factory.mktemp("bundle") / "art"
    art.save(str(path))
    return {"cfg": cfg, "tcfg": get_config("gpt2-small", reduced=True),
            "params": params, "art": art, "path": str(path)}


# "queued": the reference's traced scenario (4 requests into 2 slots, fp
# pages).  The fused bundle with prefix sharing and a pool small enough to
# preempt: "fp_spec_preempt" on f32 pages with n-gram speculation,
# "int8_preempt" on int8 pages (the quality observer's pool samples).  The
# int8 run leaves speculation out: an int8 K/V code sits on a rounding
# boundary often enough that one ulp of K (RoPE's sin and cos differ by an
# ulp between XLA and torch) flips it, and with speculation on these
# prompts one such flip moves request 0's 10th token.
SPEC_PREEMPT = dict(max_batch=3, s_max=48, page_size=4, n_pages=12,
                    prefill_chunk=8)
SCENARIOS = {
    "queued": dict(
        engine=dict(max_batch=2, s_max=32, page_size=4),
        prompts=["a b", "c d e", "f", "g h i j"], arrivals=[0, 0, 1, 2],
        max_new=4),
    "fp_spec_preempt": dict(
        engine=dict(SPEC_PREEMPT, kv_mode="fp", spec_mode="ngram", spec_k=4),
        prompts=["abcabcabcabc", "abcabcabc xyz", "the cat the cat",
                 "zzzz zzzz zzzz"], arrivals=[0, 0, 1, 1], max_new=10),
    "int8_preempt": dict(
        engine=dict(SPEC_PREEMPT, kv_mode="int8"),
        prompts=["abcabcabcabc", "abcabcabc xyz", "the cat the cat",
                 "zzzz zzzz zzzz"], arrivals=[0, 0, 1, 1], max_new=10),
}


def _drive(scenario, fused_model, port, recorder=None, quality=None):
    sc = SCENARIOS[scenario]
    if scenario == "queued":
        cfg = fused_model["cfg"].replace(n_layers=2, d_model=32, n_heads=2,
                                         n_kv_heads=2, d_ff=64, vocab_size=300)
        params = jax.tree.map(np.array, JT.init_params(
            cfg, jax.random.PRNGKey(0)))
        tcfg = fused_model["tcfg"].replace(n_layers=2, d_model=32, n_heads=2,
                                           n_kv_heads=2, d_ff=64,
                                           vocab_size=300)
        weights = params
    else:
        cfg, tcfg = fused_model["cfg"], fused_model["tcfg"]
        weights = (QuantArtifact.load(fused_model["path"]) if port
                   else fused_model["art"])
    if port:
        eng = ServeEngine(tcfg, weights, cache_dtype=torch.float32,
                          recorder=recorder, quality=quality, device="cpu",
                          **sc["engine"])
        reqs = [Request(p, max_new_tokens=sc["max_new"]) for p in sc["prompts"]]
    else:
        eng = JServeEngine(cfg, weights if scenario != "queued" else
                           jax.tree.map(jnp.asarray, weights),
                           cache_dtype=jnp.float32, recorder=recorder,
                           quality=quality, **sc["engine"])
        reqs = [JRequest(p, max_new_tokens=sc["max_new"])
                for p in sc["prompts"]]
    eng.generate(reqs, sc["arrivals"])
    assert all(r.done for r in reqs)
    return eng, reqs


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def traced(request, fused_model):
    scenario = request.param
    rec, jrec = TraceRecorder(), JTraceRecorder()
    obs, jobs = QualityObserver(), JQualityObserver()
    eng, reqs = _drive(scenario, fused_model, True, rec, obs)
    jeng, jreqs = _drive(scenario, fused_model, False, jrec, jobs)
    off, off_reqs = _drive(scenario, fused_model, True)
    return {"scenario": scenario, "rec": rec, "jrec": jrec, "obs": obs,
            "jobs": jobs, "eng": eng, "reqs": reqs, "jeng": jeng,
            "jreqs": jreqs, "off": off, "off_reqs": off_reqs}


def _plain(events):
    """Events without the wall clock, args as plain Python values."""
    def py(v):
        if isinstance(v, (list, tuple)):
            return [py(x) for x in v]
        return v.item() if hasattr(v, "item") else v
    return [{k: ({a: py(b) for a, b in ev["args"].items()} if k == "args"
                 else ev[k])
             for k in ("kind", "rid", "phase", "name", "step", "args")}
            for ev in events]


def test_traced_events_equal_reference(traced):
    rec, jrec = traced["rec"], traced["jrec"]
    assert [r.out_tokens for r in traced["reqs"]] == [
        r.out_tokens for r in traced["jreqs"]]
    assert rec.dropped == jrec.dropped == 0
    assert _plain(rec.events) == _plain(jrec.events)
    assert rec.metadata == {"mesh_devices": 1, "kv_shards": 1}
    eng, jeng = traced["eng"], traced["jeng"]
    assert (eng.decode_traces, eng.prefill_traces, eng.verify_traces) == (
        jeng.decode_traces, jeng.prefill_traces, jeng.verify_traces)
    names = {e["name"] for e in rec.events}
    assert {"SUBMITTED", "ADMITTED", "CHUNK", "FIRST_TOKEN", "FINISHED",
            "STEP", "COMPILE"} <= names
    if traced["scenario"] != "queued":
        assert "PREEMPTED" in names
        assert ("VERIFY" in names) == (traced["scenario"] == "fp_spec_preempt")


def test_traced_run_zero_perturbation(traced):
    assert [r.out_tokens for r in traced["reqs"]] == [
        r.out_tokens for r in traced["off_reqs"]]
    assert (traced["eng"].metrics.report()["decode_steps"]
            == traced["off"].metrics.report()["decode_steps"])


def test_traced_run_lifecycle_invariants(traced):
    rec, eng = traced["rec"], traced["eng"]
    errs = lifecycle_errors(rec.events, decode_steps=eng.metrics.decode_steps)
    assert errs == [], errs
    phases = {s["phase"] for spans in rec.spans().values() for s in spans}
    assert {"QUEUED", "PREFILLING", "DECODING"} <= phases
    fins = [e for e in rec.events if e["name"] == "FINISHED"]
    assert len(fins) == len(traced["reqs"])


def test_traced_run_chrome_export(traced, tmp_path):
    path = traced["rec"].export_chrome(tmp_path / "serve.json")
    assert chrome_errors(path) == []
    jpath = traced["jrec"].export_chrome(tmp_path / "jserve.json")
    strip = lambda doc: [{k: v for k, v in e.items() if k != "ts"}
                         for e in json.loads(doc.read_text())["traceEvents"]]
    assert strip(path) == strip(jpath)


def test_traced_run_compile_events(traced):
    rec, eng = traced["rec"], traced["eng"]
    compiles = [e for e in rec.events if e["name"] == "COMPILE"]
    for kind, n in (("decode", eng.decode_traces),
                    ("prefill", eng.prefill_traces),
                    ("verify", eng.verify_traces)):
        assert sum(e["args"]["kind"] == kind for e in compiles) == n
    assert eng.decode_traces == len(eng.decode_buckets) > 0
    assert eng.prefill_traces == len(eng.prefill_buckets) > 0


def test_quality_snapshots_match_reference(traced):
    snap, jsnap = traced["obs"].snapshot(), traced["jobs"].snapshot()
    _assert_quality_equal(snap, jsnap)
    if traced["scenario"] == "int8_preempt":
        assert snap["pool_samples"] > 0
    else:                                   # fp pages: nothing quantized
        assert snap == {"pool_samples": 0, "sites": {}}


def test_engine_default_recorder_is_null(traced):
    assert traced["off"].recorder is NULL_RECORDER
    assert traced["off"].recorder.events == []


# ---------------------------------------------------------------------------
# the activation seam: eager forwards observe, the serve steps never do
# ---------------------------------------------------------------------------

def test_eager_forward_under_quantctx_observes_as_reference(fused_model):
    """An eager forward under the fused QuantCtx reports every site, with
    the same counts and amax as the reference's eager forward."""
    cfg, tcfg = fused_model["cfg"], fused_model["tcfg"]
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    jctx, _ = jas_ctx(fused_model["art"])
    jobs, obs = JQualityObserver(), QualityObserver()
    prev = jdispatch.set_quality_observer(jobs)
    try:
        JT.forward(cfg, fused_model["art"].params, jnp.asarray(tokens), jctx,
                   scan=False)
    finally:
        jdispatch.set_quality_observer(prev)
    tart = QuantArtifact.load(fused_model["path"])
    prev = dispatch.set_quality_observer(obs)
    try:
        T.forward(tcfg, as_port_params(tcfg, tart.params, "cpu"),
                  torch.as_tensor(tokens), as_ctx(tart, "cpu"))
    finally:
        dispatch.set_quality_observer(prev)
    assert len(obs.sites) == 4 * cfg.n_layers
    _assert_quality_equal(obs.snapshot(), jobs.snapshot())
    assert any(s.hot_hits for s in obs.sites.values())


def test_serve_steps_observe_nothing(fused_model, monkeypatch):
    """With an observer installed, the engine's prefill, decode and verify
    steps run with observation suspended: no activation reaches it."""
    seen = []
    for name in ("prefill_chunk_paged", "decode_step_paged",
                 "decode_verify_paged"):
        fn = getattr(T, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, dispatch.quality_observer()))
            return _fn(*a, **kw)
        monkeypatch.setattr(T, name, spy)
    obs = QualityObserver()
    prev = dispatch.set_quality_observer(obs)
    try:
        eng, _ = _drive("fp_spec_preempt", fused_model, True, quality=obs)
    finally:
        dispatch.set_quality_observer(prev)
    assert {n for n, _ in seen} == {"prefill_chunk_paged", "decode_step_paged",
                                    "decode_verify_paged"}
    assert all(o is None for _, o in seen)
    assert obs.sites == {} and isinstance(eng.ctx, QuantCtx)
