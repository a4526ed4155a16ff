"""Tensor-parallel paged serving of the port (``ServeEngine(tp=N)`` over
``torch.distributed``, ``parallel/serve_sharding.py``) against its own
single-device serve and the JAX reference's — the port's counterpart of
``tests/test_serve_tp.py``.

The ranks are gloo processes spawned in-test on the CPU
(``parallel.ranks.run_ranks``: a file rendezvous in a fresh temporary
directory, every collective under a timeout), once per world size (2 and
4), each running every scenario below on the reduced gpt2 (4 heads, 4 KV
heads, 2 layers).  The load-bearing claim is BIT-identical token streams:
attention outputs and logits merge with a zero-pad all-reduce, and the
int8/int4 page quantizers are head-local, so every rank's stream at tp = 2
and 4 equals the port's tp = 1 stream, which equals the reference's
single-device stream (its own tests hold its tp = N to its tp = 1).

Weights: the reference's ``init_params`` tree as numpy, with the
LayerNorm gains of a few channels x20 (activation outliers) and one K
channel of KV heads 0 and 3 x20 (KV outliers, so the int4 redistribution
rows that the ranks slice are not the identity on either side of a
shard).  The fused MUXQ artifact is a bundle the reference wrote.  This
module imports no JAX at top level: the ranks import it by name to find
their function.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as PA
from repro_torch.obs.quality import QualityObserver
from repro_torch.obs.trace import TraceRecorder
from repro_torch.parallel import serve_sharding as SS
from repro_torch.parallel.ranks import run_ranks
from repro_torch.quantize import QuantArtifact
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import quantize_kv
from repro_torch.serve.kvq import Int4KVQuantizer, redist_from_mask

HOT = [3, 17, 40]           # LayerNorm channels scaled x20
K_HOT_HEADS = (0, 3)        # KV heads with a K channel scaled x20
TIMEOUT_S = 300.0           # a world's whole run, and each collective's

COMMON = dict(max_batch=2, s_max=64, page_size=16, prefill_chunk=8)
PROMPTS = ["the model computes", "a kernel shards"]
# name -> (model, served, engine kwargs, prompts, max_new, arrivals)
SCENARIOS = {
    "fp": ("base", "params", dict(kv_mode="fp"), PROMPTS, 8, None),
    "int8": ("base", "params", dict(kv_mode="int8"), PROMPTS, 8, None),
    "int4": ("base", "artifact", dict(kv_mode="int4"), PROMPTS, 8, None),
    "spec_prefix": ("base", "params",
                    dict(kv_mode="fp", spec_mode="ngram", spec_k=3),
                    ["the model computes", "the model computes",
                     "a kernel shards"], 10, [0, 1, 3]),
    "preempt": ("base", "params",
                dict(kv_mode="fp", page_size=4, s_max=32, n_pages=8),
                ["the model", "a kernel", "the model"], 14, [0, 0, 1]),
    "gqa": ("gqa", "params", dict(kv_mode="fp"), PROMPTS, 8, None),
    "fused_int8": ("base", "artifact", dict(kv_mode="int8"), PROMPTS, 8, None),
}
# scenarios served again with the quality observer sampling every step
QUALITY = ("int8", "int4")
AMAX_RTOL = 1e-6           # the observer's amax against the reference's
COUNTERS = ("decode_steps", "prefill_steps", "prefix_hits", "cow_copies",
            "preemptions", "spec_verify_steps", "spec_proposed",
            "spec_accepted", "tokens_out", "cache_bytes", "bytes_per_token")


def _engine(tcfg, served, kw, tp, **extra):
    return ServeEngine(tcfg, served, **{**COMMON, **kw}, tp=tp,
                       cache_dtype=torch.float32, device="cpu", **extra)


def _serve(models, name, tp, **extra):
    """Serve one scenario in this process (one rank of ``tp``): the
    streams, the counters and the pool's shard accounting."""
    model, served, kw, prompts, max_new, arrivals = SCENARIOS[name]
    tcfg, params, bundle = models[model]
    served = QuantArtifact.load(bundle) if served == "artifact" else params
    eng = _engine(tcfg, served, kw, tp, **extra)
    reqs = [Request(p, max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, arrivals=arrivals)
    assert all(r.done for r in reqs)
    assert eng.decode_traces == len(eng.decode_buckets)
    assert eng.prefill_traces == len(eng.prefill_buckets)
    assert eng.verify_traces == len(eng.verify_buckets)
    rep = eng.metrics.report()
    return {"streams": [r.out_tokens for r in reqs],
            "counters": {c: rep[c] for c in COUNTERS},
            "heads_sharded": eng.pool.heads_sharded,
            "kv_shards": eng.pool.kv_shards,
            "cache_bytes": eng.pool.cache_bytes(),
            "per_shard": eng.pool.cache_bytes_per_shard(),
            "stats": {k: eng.pool.stats()[k]
                      for k in ("kv_shards", "cache_bytes_per_shard")},
            "k_redist": (eng.pool.kv["k_redist"].numpy()
                         if "k_redist" in eng.pool.kv else None),
            "engine": eng}


def _observed(models, name, tp):
    """The quality observer's snapshot of one scenario's serve, sampling
    the pool at every scheduler step."""
    obs = QualityObserver(sample_every=1)
    _serve(models, name, tp, quality=obs)
    return obs.snapshot()


def _rank(rank, tp, models, out_dir):
    """One rank of a ``tp``-way world: every scenario, the observability
    surface, the collectives' algebra and the group checks."""
    torch.set_num_threads(1)
    res = {}
    for name in SCENARIOS:
        r = _serve(models, name, tp)
        del r["engine"]
        res[name] = r
    res["quality"] = {name: _observed(models, name, tp) for name in QUALITY}
    # observability: gauges, report, recorder metadata, Chrome labels
    rec = TraceRecorder()
    r = _serve(models, "fp", tp, recorder=rec)
    eng = r["engine"]
    path = rec.export_chrome(f"{out_dir}/trace{tp}_{rank}.json")
    doc = json.loads(open(path).read())
    res["obs"] = {
        "gauges": (eng.metrics.registry.value("serve/mesh_devices"),
                   eng.metrics.registry.value("serve/kv_shards")),
        "report": {k: eng.metrics.report()[k]
                   for k in ("kv_shards", "cache_bytes",
                             "cache_bytes_per_shard")},
        "metadata": dict(rec.metadata),
        "other": doc["otherData"],
        "labels": [e["args"]["labels"] for e in doc["traceEvents"]
                   if e.get("name") == "process_labels"]}
    # the zero-pad merges against the unsharded computation
    shard = SS.HeadShard(rank, tp, None)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, 64, generator=gen)
    head = torch.randn(64, 512, generator=gen)
    o = torch.randn(3, 5, 8, 16, generator=gen)
    with SS.head_sharding(shard):
        logits = SS.tp_logits(x, head)
        heads = SS.all_heads(SS.slice_heads(o, shard), 8, shard)
    with SS.head_sharding(SS.HeadShard(rank, tp, None)):
        odd = SS.tp_logits(x, head[:, :510])   # V the group does not divide
    res["algebra"] = (torch.equal(logits, x @ head), torch.equal(heads, o),
                      torch.equal(odd, x @ head[:, :510]))
    try:
        SS.serve_group(2 * tp)
        res["too_large"] = None
    except ValueError as e:
        res["too_large"] = str(e)
    res["group_ok"] = SS.serve_group(tp) is not None
    return res


# ---------------------------------------------------------------------------
# Fixtures: the reference's model and streams, the port at tp 1, 2 and 4
# ---------------------------------------------------------------------------

def _plant(cfg, params):
    for ln in ("ln1", "ln2"):
        params["layers"][ln]["gain"][:, HOT] *= 20.0
    k0 = cfg.n_heads * cfg.head_dim
    for h in K_HOT_HEADS:
        if h < cfg.n_kv_heads:
            params["layers"]["attn"]["wqkv"][:, :, k0 + h * cfg.head_dim + 1] *= 20.0
    return params


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights, its fused MUXQ bundle and its
    single-device stream of every scenario (f32 pages)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core.muxq import QuantConfig as JQuantConfig
    from repro.core.policy import SitePolicy as JSitePolicy
    from repro.models import transformer as JT
    from repro.obs.quality import QualityObserver as JQualityObserver
    from repro.quantize import quantize_model
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    cfg = jget_config("gpt2-small", reduced=True)
    gcfg = cfg.replace(n_kv_heads=2)
    trees = {}
    for name, c, seed in (("base", cfg, 0), ("gqa", gcfg, 1)):
        trees[name] = _plant(c, jax.tree.map(
            np.array, JT.init_params(c, jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
               for _ in range(2)]
    spec = JQuantConfig(method="muxq", outlier_mode="static",
                        act_granularity="per_token",
                        weight_granularity="per_channel", backend="fused")
    art = quantize_model(cfg, jax.tree.map(jnp.asarray, trees["base"]),
                         batches, JSitePolicy.uniform(spec))
    bundle = str(tmp_path_factory.mktemp("bundle") / "art")
    art.save(bundle)
    tcfg = get_config("gpt2-small", reduced=True)
    models = {"base": (tcfg, trees["base"], bundle),
              "gqa": (tcfg.replace(n_kv_heads=2), trees["gqa"], bundle)}
    jcfgs = {"base": cfg, "gqa": gcfg}
    streams, quality = {}, {}
    for name, (model, served, kw, prompts, max_new, arrivals) in SCENARIOS.items():
        jserved = art if served == "artifact" else jax.tree.map(
            jnp.asarray, trees[model])
        observers = [None] + ([JQualityObserver(sample_every=1)]
                              if name in QUALITY else [])
        for obs in observers:
            eng = JServeEngine(jcfgs[model], jserved, cache_dtype=jnp.float32,
                               quality=obs, **{**COMMON, **kw})
            reqs = [JRequest(p, max_new_tokens=max_new) for p in prompts]
            eng.generate(reqs, arrivals=arrivals)
        streams[name] = [r.out_tokens for r in reqs]
        if name in QUALITY:
            quality[name] = observers[-1].snapshot()
    return {"models": models, "streams": streams, "quality": quality}


@pytest.fixture(scope="module")
def tp1(reference):
    return {name: _serve(reference["models"], name, None)
            for name in SCENARIOS}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results at tp 2 and at tp 4 (one spawn a world)."""
    out = tmp_path_factory.mktemp("traces")
    return {tp: run_ranks(_rank, tp, (tp, reference["models"], str(out)),
                          backend="gloo", timeout_s=TIMEOUT_S)
            for tp in (2, 4)}


def _every_rank_serves(ranks, tp1, name, tp):
    base = tp1[name]
    for rank, res in enumerate(ranks[tp]):
        r = res[name]
        assert r["streams"] == base["streams"], (name, tp, rank)
        assert r["counters"] == base["counters"], (name, tp, rank)
    return ranks[tp][0][name], base


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_tp1_streams_match_the_reference(reference, tp1, name):
    """Every scenario's baseline: the port on one device serves the
    reference's single-device stream."""
    assert tp1[name]["streams"] == reference["streams"][name]
    assert tp1[name]["kv_shards"] == 1 and not tp1[name]["heads_sharded"]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_fp_parity_and_shard_bytes(ranks, tp1, tp):
    """fp pages: every rank's stream equals tp = 1's, and each rank holds
    exactly global / tp of the pool's bytes; the global figure is the
    same at every tp."""
    r, base = _every_rank_serves(ranks, tp1, "fp", tp)
    g = base["cache_bytes"]
    assert base["per_shard"] == g
    assert r["heads_sharded"] and r["kv_shards"] == tp
    assert r["cache_bytes"] == g
    assert r["per_shard"] == g // tp
    assert r["stats"] == {"kv_shards": tp, "cache_bytes_per_shard": g // tp}


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_quantized_pages_exact(ranks, tp1, tp):
    """int8 pages and calibrated int4 pages (each rank's slice of the
    redistribution rows): the page quantizers are head-local, so the
    sharded streams equal the single-device ones."""
    for name in ("int8", "int4"):
        r, base = _every_rank_serves(ranks, tp1, name, tp)
        assert r["kv_shards"] == tp
        assert r["per_shard"] * tp == r["cache_bytes"] == base["cache_bytes"]
    # the calibrated rows of KV heads 0 and 3 are not the identity, and
    # the ranks' slices of them make up the whole
    rows = tp1["int4"]["k_redist"]
    assert (rows[:, list(K_HOT_HEADS)] > 1).any(axis=-1).all()
    parts = [res["int4"]["k_redist"] for res in ranks[tp]]
    assert all(p.shape[1] == rows.shape[1] // tp for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), rows)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_spec_decode_and_prefix_sharing_parity(ranks, tp1, tp):
    """n-gram speculation, duplicate prompts sharing their prefix pages
    and staggered arrivals: streams, prefix hits and accepted drafts equal
    the single-device serve's."""
    r, base = _every_rank_serves(ranks, tp1, "spec_prefix", tp)
    assert base["counters"]["prefix_hits"] > 0
    assert base["counters"]["spec_verify_steps"] > 0
    assert r["counters"]["spec_accepted"] == base["counters"]["spec_accepted"]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_preemption_replay_parity(ranks, tp1, tp):
    """A pool too small for the working set preempts and replays; the
    replayed streams are the same at every tp."""
    r, base = _every_rank_serves(ranks, tp1, "preempt", tp)
    assert base["counters"]["preemptions"] > 0


def test_tp_gqa_fallback_replicated(ranks, tp1):
    """n_kv_heads 2: tp = 4 does not divide it and serves on a replicated
    pool with no collectives; tp = 2 shards it."""
    g = tp1["gqa"]["cache_bytes"]
    r4, _ = _every_rank_serves(ranks, tp1, "gqa", 4)
    assert not r4["heads_sharded"] and r4["kv_shards"] == 1
    assert r4["per_shard"] == g
    r2, _ = _every_rank_serves(ranks, tp1, "gqa", 2)
    assert r2["heads_sharded"] and r2["kv_shards"] == 2
    assert r2["per_shard"] == g // 2


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_quantized_artifact_parity(ranks, tp1, tp):
    """The reference's fused MUXQ bundle on int8 pages: weights replicated
    on every rank, pages sharded by head, streams unchanged."""
    r, _ = _every_rank_serves(ranks, tp1, "fused_int8", tp)
    assert r["kv_shards"] == tp


def _assert_quality_equal(snap, jsnap, amax_rtol=0.0):
    assert snap["pool_samples"] == jsnap["pool_samples"] > 0
    assert set(snap["sites"]) == set(jsnap["sites"]) == {"kv/k", "kv/v"}
    for name, s in snap["sites"].items():
        j = jsnap["sites"][name]
        for key in ("calls", "elements", "clip_rate", "hot_channels",
                    "outlier_hit_rate"):
            assert s[key] == j[key], (name, key, s[key], j[key])
        np.testing.assert_allclose(s["amax"], j["amax"], rtol=amax_rtol,
                                   err_msg=name)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", QUALITY)
def test_tp_quality_snapshot_equals_single_device(reference, ranks, tp, name):
    """Every rank's KV-page quality snapshot, from its own heads and the
    group's gathered channel amax and counts, equals the port's tp = 1
    snapshot exactly and the reference's global one (amax within
    AMAX_RTOL)."""
    one = _observed(reference["models"], name, None)
    _assert_quality_equal(one, reference["quality"][name], AMAX_RTOL)
    if name == "int4":
        assert one["sites"]["kv/k"]["hot_channels"] > 0
    for rank, res in enumerate(ranks[tp]):
        _assert_quality_equal(res["quality"][name], one)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_mesh_obs_surface(ranks, tp):
    """The group's shape reaches the registry's gauges, the report, the
    recorder's metadata and the Chrome trace's process labels, on every
    rank."""
    for res in ranks[tp]:
        obs = res["obs"]
        assert obs["gauges"] == (float(tp), float(tp))
        assert obs["report"]["kv_shards"] == float(tp)
        assert obs["report"]["cache_bytes_per_shard"] * tp == \
            obs["report"]["cache_bytes"]
        assert obs["metadata"]["mesh_devices"] == tp
        assert obs["other"]["mesh_devices"] == tp
        assert obs["other"]["kv_shards"] == tp
        assert obs["labels"] and all(f"mesh_devices={tp}" in lab
                                     for lab in obs["labels"])


@pytest.mark.parametrize("tp", [2, 4])
def test_zero_pad_merges_equal_the_unsharded_results(ranks, tp):
    """On every rank: ``tp_logits`` equals the full head's matmul bit for
    bit (and takes the full matmul where the group does not divide
    V_pad), and ``all_heads`` of a rank's head slice gives back every
    head."""
    for res in ranks[tp]:
        assert res["algebra"] == (True, True, True)


@pytest.mark.parametrize("tp", [2, 4])
def test_serve_group_larger_than_the_group_raises(ranks, tp):
    for res in ranks[tp]:
        assert res["group_ok"]
        msg = res["too_large"]
        assert msg is not None and f"{2 * tp}-rank" in msg
        assert "init_process_group" in msg


def test_serve_group_without_a_process_group_raises(reference):
    """The counterpart of ``serve_mesh``'s device-count error: no group
    initialized names the launcher's --tp and init_process_group, from
    ``serve_group`` and from an engine asked for tp = 2."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--tp 2") as e:
        SS.serve_group(2)
    assert "init_process_group" in str(e.value)
    with pytest.raises(ValueError, match=">= 1"):
        SS.serve_group(0)
    tcfg, params, _ = reference["models"]["base"]
    with pytest.raises(ValueError, match="--tp 2"):
        _engine(tcfg, params, {}, 2)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        _engine(tcfg, params, {}, 0)


@pytest.mark.parametrize("mode", ["fp", "int8", "int4"])
def test_plain_paged_attention_per_head_shard_equals_the_full_call(mode):
    """The paged read derives kvh and the GQA group from its operands, so
    the plain version run on each KV-head shard (pages, scales and
    redistribution rows sliced) and concatenated over heads equals the
    full-width call bit for bit — the property the sharded attention
    relies on (the reference's ``test_kernel_head_slice_parity``)."""
    b, h, kvh, dh, ps, npages = 2, 8, 4, 16, 8, 6
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((npages, ps, kvh, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((npages, ps, kvh, dh)).astype(np.float32))
    table = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
    pos = torch.tensor([13, 9], dtype=torch.int32)
    kw = {}
    if mode == "int8":
        parts = quantize_kv(k, v)
        k, v = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
    elif mode == "int4":
        mask = np.zeros((kvh, dh), bool)
        mask[[0, 3], 1] = True
        redist = torch.from_numpy(redist_from_mask(mask))
        parts = Int4KVQuantizer(redist, redist).quantize(k, v)
        k, v = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"],
              "k_redist": redist, "v_redist": redist}
    full = PA.paged_attention_plain(q, k, v, table, pos, **kw)
    g = h // kvh
    for shards in (2, 4):
        kl, hl = kvh // shards, kvh // shards * g
        out = []
        for i in range(shards):
            heads = slice(i * kl, (i + 1) * kl)
            skw = {n: (t[heads] if n.endswith("redist") else t[:, :, heads])
                   for n, t in kw.items()}
            out.append(PA.paged_attention_plain(
                q[:, i * hl:(i + 1) * hl], k[:, :, heads], v[:, :, heads],
                table, pos, **skw))
        assert torch.equal(torch.cat(out, dim=1), full), (mode, shards)
