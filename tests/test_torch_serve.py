"""Model- and engine-level parity of the PyTorch port against the JAX
reference, on the reduced gpt2 config (2 layers, d_model 64).

Both packages get the same weights: the reference's ``init_params`` tree
(with the LayerNorm gains of a few channels scaled up so calibration finds
outliers) goes to the port through ``repro_torch.convert.from_jax_params``,
and the quantized artifact is a bundle the reference's
``QuantArtifact.save`` wrote, loaded by the port's ``QuantArtifact.load``.
Paged results are compared with the reference's paged steps
(``decode_step_paged`` / ``prefill_chunk_paged``), not with its dense
decode.  The port runs on CPU tensors, i.e. through the kernels' plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.context import CollectCtx as JCollectCtx
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.context import as_ctx as jas_ctx
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.core.policy import SitePolicy as JSitePolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.quantize import quantize_model
from repro.serve import kvq as jkvq
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.context import CollectCtx, FpCtx, QuantCtx, as_ctx
from repro_torch.core.muxq import QuantConfig
from repro_torch.core.policy import SitePolicy
from repro_torch.kernels import dispatch
from repro_torch.kernels.quantize import rowwise_quantize
from repro_torch.models import transformer as T
from repro_torch.quantize import QuantArtifact, pack_kernel_buffers
from repro_torch.serve import kvq
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pool import PagePool
from repro_torch.serve.scheduler import Scheduler

FUSED = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
             weight_granularity="per_channel", backend="fused")
HOT = [3, 17, 40]          # LayerNorm channels scaled x20 (calibrated outliers)
LOGIT_ATOL = 1e-4          # f32 logits: op order differs between frameworks


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cfg = jget_config("gpt2-small", reduced=True)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    for ln in ("ln1", "ln2"):
        params["layers"][ln]["gain"][:, HOT] *= 20.0
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
               for _ in range(2)]
    jparams = jax.tree.map(jnp.asarray, params)
    art = quantize_model(cfg, jparams, batches,
                         JSitePolicy.uniform(JQuantConfig(**FUSED)))
    path = tmp_path_factory.mktemp("bundle") / "art"
    art.save(str(path))
    return {"cfg": cfg, "tcfg": get_config("gpt2-small", reduced=True),
            "params": params, "jparams": jparams, "batches": batches,
            "art": art, "path": str(path)}


def test_config_and_param_conversion(model):
    cfg, tcfg = model["cfg"], model["tcfg"]
    assert (tcfg.n_layers, tcfg.d_model, tcfg.padded_vocab, tcfg.head_dim) == (
        cfg.n_layers, cfg.d_model, cfg.padded_vocab, cfg.head_dim)
    tp = from_jax_params(tcfg, model["params"], device="cpu")
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            tp["layers"][i]["attn"]["wqkv"].numpy(),
            model["params"]["layers"]["attn"]["wqkv"][i])
    np.testing.assert_array_equal(tp["embed"].numpy(), model["params"]["embed"])
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(tcfg.replace(n_layers=3), model["params"], device="cpu")


def test_artifact_load_and_torch_packing_match_bundle(model):
    """The port reads the reference's bundle, and packing the same params
    under the loaded masks in torch gives the same kernel buffers."""
    art = QuantArtifact.load(model["path"])
    jart = model["art"]
    assert art.policy.to_json() == jart.policy.to_json()
    assert set(art.kernel_buffers) == set(jart.kernel_buffers)
    assert any(m.any() for m in art.masks.values())
    buffers = pack_kernel_buffers(model["tcfg"],
                                  from_jax_params(model["tcfg"], model["params"],
                                                  device="cpu"),
                                  art.policy, art.masks)
    assert set(buffers) == set(jart.kernel_buffers)
    for site, buf in buffers.items():
        for f in dispatch.BUFFER_FIELDS:
            np.testing.assert_array_equal(buf[f], art.kernel_buffers[site][f],
                                          err_msg=f"{site}#{f}")


def test_fused_matmul_on_reference_bundle(model):
    """Codes equal, f32 output allclose (rtol 1e-5) against the reference's
    ``ops.muxq_linear_ref`` on every packed site of the bundle."""
    art = QuantArtifact.load(model["path"])
    rng = np.random.default_rng(1)
    n_outlier_sites = 0
    for site, buf in sorted(art.kernel_buffers.items()):
        k = int(buf["gather_idx"].max()) + 1
        x = rng.standard_normal((5, k)).astype(np.float32)
        x[:, HOT[:1]] *= 30.0
        jmw = jdispatch.as_muxq_weights({f: jnp.asarray(v) for f, v in buf.items()})
        jbody = jops._permute_pad_shift(jnp.asarray(x), jmw)
        qj, _ = jref.rowwise_quantize_ref(jbody, 8)
        yj = np.asarray(jops.muxq_linear_ref(jnp.asarray(x), jmw))
        tbuf = dispatch.buffer_to(buf, "cpu")
        qt, _ = rowwise_quantize(torch.from_numpy(x), 8,
                                 gather_idx=tbuf["gather_idx"],
                                 in_scale=tbuf["in_scale"])
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj), err_msg=site)
        yt = dispatch.fused_matmul(torch.from_numpy(x), tbuf)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6,
                                   err_msg=site)
        n_outlier_sites += int((buf["block_scale"] > 1).any())
    assert n_outlier_sites > 0


def test_calibration_through_paged_prefill_matches_reference(model):
    """CollectCtx over the port's fp paged prefill (one chunk = the whole
    sequence) sees the reference full forward's activations."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    tokens = model["batches"][0]["tokens"]
    jctx = JCollectCtx()
    JT.forward(cfg, model["jparams"], jnp.asarray(tokens), jctx, scan=False)
    b, s = tokens.shape
    pool = PagePool(tcfg, b, s, page_size=16, mode="fp", dtype=torch.float32,
                    device="cpu")
    ctx = CollectCtx()
    table = torch.arange(1, 1 + b, dtype=torch.int32)[:, None]
    zero = torch.zeros(b, dtype=torch.int32)
    T.prefill_chunk_paged(tcfg, from_jax_params(tcfg, model["params"], "cpu"),
                          torch.from_numpy(tokens.astype(np.int32)), pool.kv,
                          table, zero, zero, torch.full((b,), s, dtype=torch.int32),
                          ctx)
    assert set(ctx.stats.sites) == set(jctx.stats.sites)
    for site, st in ctx.stats.sites.items():
        np.testing.assert_allclose(st.absmax, jctx.stats.sites[site].absmax,
                                   rtol=1e-4, atol=1e-4, err_msg=site)
    masks, jmasks = ctx.stats.masks(), jctx.stats.masks()
    for site in masks:
        np.testing.assert_array_equal(masks[site], jmasks[site], err_msg=site)


def _paged_pair(model, quant, mode):
    """Run one 2-slot prefill chunk then one decode step through both
    packages on identical pools; returns the (jax, torch) logits pairs."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    n_pages, ps, b, C = 9, 4, 2, 8
    jkv = jkvq.make_quantizer(mode, kvh=cfg.n_kv_heads, dh=cfg.head_dim,
                              dtype=jnp.float32).page_arrays(
        cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    tkv = kvq.make_quantizer(mode, dtype=torch.float32).page_arrays(
        tcfg.n_layers, n_pages, ps, tcfg.n_kv_heads, tcfg.head_dim, "cpu")
    if quant is None:
        jctx, qparams = jas_ctx(None)
        tctx, tparams = FpCtx(), from_jax_params(tcfg, model["params"], "cpu")
    else:
        jctx, qparams = jas_ctx(model["art"])
        tart = QuantArtifact.load(model["path"])
        tctx = as_ctx(tart, "cpu")
        tparams = from_jax_params(tcfg, tart.params, "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (b, C)).astype(np.int32)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    start = np.array([0, 0], np.int32)
    w_hi = np.array([C, 5], np.int32)            # slot 1: 5 valid tokens
    jl, jkv = JT.prefill_chunk_paged(
        cfg, model["jparams"] if quant is None else model["art"].params,
        jnp.asarray(toks), jkv, jnp.asarray(table), jnp.asarray(start),
        jnp.asarray(start), jnp.asarray(w_hi), jctx, qparams=qparams)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tl, tkv = T.prefill_chunk_paged(tcfg, tparams, tt(toks), tkv, tt(table),
                                    tt(start), tt(start), tt(w_hi), tctx)
    out = [(np.asarray(jl), tl.numpy())]
    dtok = np.array([[7], [11]], np.int32)
    pos = w_hi.copy()
    jl, jkv = JT.decode_step_paged(
        cfg, model["jparams"] if quant is None else model["art"].params,
        jnp.asarray(dtok), jkv, jnp.asarray(table), jnp.asarray(pos), jctx,
        qparams=qparams)
    tl, tkv = T.decode_step_paged(tcfg, tparams, tt(dtok), tkv, tt(table),
                                  tt(pos), tctx)
    out.append((np.asarray(jl), tl.numpy()))
    return out


@pytest.mark.parametrize("quant,mode", [(None, "fp"), ("fused", "int8"),
                                        ("fused", "fp")])
def test_paged_steps_logits_match_reference(model, quant, mode):
    """prefill_chunk_paged then decode_step_paged: f32 logits within 1e-4."""
    for jl, tl in _paged_pair(model, quant, mode):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("quant,mode", [(None, "fp"), ("fused", "int8"),
                                        ("fused", "fp")])
def test_prefill_on_the_advancing_rows_equals_the_full_width_call(
        model, quant, mode):
    """What the scheduler relies on: ``prefill_chunk_paged`` over only the
    rows of the slots that advance a chunk gives those rows the logits
    (f32, within LOGIT_ATOL) and writes the K/V pages and scales, bit for
    bit, of the full-width call whose other rows are empty (zeroed table
    rows, empty write windows).  Two chunks, the second a short one."""
    tcfg = model["tcfg"]
    n_slots, ps, C, rows = 4, 4, 8, [1, 3]
    quantizer = kvq.make_quantizer(mode, dtype=torch.float32)
    kv_full, kv_rows = (quantizer.page_arrays(
        tcfg.n_layers, 1 + 4 * n_slots, ps, tcfg.n_kv_heads, tcfg.head_dim,
        "cpu") for _ in range(2))
    if quant is None:
        ctx, params = FpCtx(), from_jax_params(tcfg, model["params"], "cpu")
    else:
        tart = QuantArtifact.load(model["path"])
        ctx, params = as_ctx(tart, "cpu"), from_jax_params(tcfg, tart.params,
                                                            "cpu")
    table = np.zeros((n_slots, 4), np.int32)
    table[rows] = 1 + np.arange(4 * len(rows), dtype=np.int32).reshape(-1, 4)
    rng = np.random.default_rng(5)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for done, valid in ((0, [C, C]), (C, [C, 5])):
        toks = np.zeros((n_slots, C), np.int32)
        start = np.zeros(n_slots, np.int32)
        w_hi = np.zeros(n_slots, np.int32)
        for j, n in zip(rows, valid):
            toks[j, :n] = rng.integers(0, tcfg.vocab_size, n)
            start[j], w_hi[j] = done, done + n
        full, kv_full = T.prefill_chunk_paged(
            tcfg, params, tt(toks), kv_full, tt(table), tt(start), tt(start),
            tt(w_hi), ctx)
        part, kv_rows = T.prefill_chunk_paged(
            tcfg, params, tt(toks[rows]), kv_rows, tt(table[rows]),
            tt(start[rows]), tt(start[rows]), tt(w_hi[rows]), ctx)
        assert part.shape == (len(rows),) + tuple(full.shape[1:])
        np.testing.assert_allclose(part.numpy(), full[rows].numpy(), rtol=0,
                                   atol=LOGIT_ATOL)
        # every page a slot owns; scratch page 0 takes the masked writes,
        # the empty rows' too
        assert kv_full.keys() == kv_rows.keys()
        for name in kv_full:
            assert torch.equal(kv_rows[name][:, 1:], kv_full[name][:, 1:]), (
                done, name)


COUNTERS = ("decode_steps", "prefill_chunks", "prefill_steps", "preemptions",
            "prefix_hits", "cow_copies", "prefills", "tokens_out")

# the engine's settings that a scenario's own overrides start from
ENGINE = {"max_batch": 3, "s_max": 48, "prefill_chunk": 8}

SCENARIOS = {
    # mixed prompt lengths, multi-chunk prefill interleaved with decode
    "mixed_int8": (dict(kv_mode="int8"),
                   ["abc", "the paged pool serves", "x", "long " * 9], None),
    "mixed_fp": (dict(kv_mode="fp"),
                 ["abc", "the paged pool serves", "x", "long " * 9], None),
    # shared prompt prefixes (prefix hits + copy-on-write) and a pool
    # small enough to preempt
    "shared_preempt": (dict(kv_mode="int8", page_size=4, n_pages=9),
                       ["shared prefix one", "shared prefix two", "shared pr",
                        "other"], None),
    # staggered arrivals of prompts of several chunks, every slot free to
    # prefill: the prefill call's row count follows the slots that advance,
    # down to the last slot alone while the lower ones decode
    "staggered_rows": (dict(kv_mode="int8", max_batch=4, prefill_slots=4),
                       ["abc", "two chunks and one", "a prompt of three chunk",
                        "the last slot prefills alone here"], [0, 1, 2, 3]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_streams_and_counters_match_reference(model, scenario):
    """ServeEngine on the reference-written bundle at f32: identical token
    streams and step/preemption/sharing counters."""
    kw, prompts, arrivals = SCENARIOS[scenario]
    common = {**ENGINE, **kw}
    jeng = JServeEngine(model["cfg"], model["art"], cache_dtype=jnp.float32,
                        **common)
    jreqs = [JRequest(p, max_new_tokens=6) for p in prompts]
    jeng.generate(jreqs, arrivals)
    teng = ServeEngine(model["tcfg"], QuantArtifact.load(model["path"]),
                       cache_dtype=torch.float32, device="cpu", **common)
    treqs = [Request(p, max_new_tokens=6) for p in prompts]
    teng.generate(treqs, arrivals)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])
    assert teng.decode_buckets == jeng.decode_buckets
    assert teng.prefill_buckets == jeng.prefill_buckets
    if scenario == "shared_preempt":
        assert trep["prefix_hits"] > 0 and trep["preemptions"] > 0


def _serve_spied(model, monkeypatch, prompts, arrivals=None, **kw):
    """Serve ``prompts`` on the port's engine (reference-written bundle,
    f32) with the chunk picker and the prefill call spied on.  Returns the
    engine, the requests and one record a prefill call: the picked slots in
    slot order, their prompt positions, the slots decoding, the shapes and
    routing the call got, and the token sampled at each fresh prompt's
    last position (by request)."""
    picks, calls = [], []
    pick = Scheduler._prefill_pick

    def spy_pick(self, cands, step_clock):
        picked = pick(self, cands, step_clock)
        chosen = sorted(picked)
        st = {j: self.slots[j] for j in chosen}
        ns = {j: min(self.prefill_chunk, len(s.ids) - s.pre_pos)
              for j, s in st.items()}
        picks.append({
            "chosen": chosen, "pre_pos": [st[j].pre_pos for j in chosen],
            "ns": ns, "table": self.pool.page_table[chosen].copy(),
            "decoding": [i for i, s in enumerate(self.slots)
                         if s is not None and not s.prefilling],
            "last": {j: st[j].req for j in chosen
                     if st[j].pre_pos + ns[j] >= len(st[j].ids)
                     and not st[j].req.out_tokens}})
        return picked

    monkeypatch.setattr(Scheduler, "_prefill_pick", spy_pick)
    common = {**ENGINE, **kw}
    eng = ServeEngine(model["tcfg"], QuantArtifact.load(model["path"]),
                      cache_dtype=torch.float32, device="cpu", **common)
    prefill = eng._prefill_pool

    def spy_prefill(tokens, kv, page_table, start, write_lo, write_hi):
        nxt, kv = prefill(tokens, kv, page_table, start, write_lo, write_hi)
        p = picks[len(calls)]
        calls.append({**p, "tokens": tuple(tokens.shape),
                      "page_table": page_table.numpy().copy(),
                      "start": start.tolist(), "write_hi": write_hi.tolist(),
                      "first": {id(p["last"][j]): int(nxt[p["chosen"].index(j),
                                                           p["ns"][j] - 1])
                                for j in p["last"]}})
        return nxt, kv

    eng._prefill_pool = spy_prefill
    reqs = [Request(p, max_new_tokens=6) for p in prompts]
    eng.generate(reqs, arrivals)
    assert all(r.done for r in reqs) and len(calls) == len(picks)
    return eng, reqs, calls


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_prefill_call_carries_only_the_advancing_slots(model, monkeypatch,
                                                       scenario):
    """Every prefill call gets one row per slot the picker chose, in slot
    order, never the pool's width when fewer advance; each row carries its
    slot's page table, start and write window; each fresh prompt's first
    token is the one sampled at its own row; ``prefill_computed_tokens``
    counts rows x chunk bucket over the calls."""
    kw, prompts, arrivals = SCENARIOS[scenario]
    eng, reqs, calls = _serve_spied(model, monkeypatch, prompts, arrivals,
                                    **kw)
    firsts = {}
    for c in calls:
        assert c["tokens"][0] == len(c["chosen"]) >= 1
        assert c["start"] == c["pre_pos"]
        assert c["write_hi"] == [p + c["ns"][j] for j, p in
                                 zip(c["chosen"], c["pre_pos"])]
        pb = c["page_table"].shape[1]
        np.testing.assert_array_equal(c["page_table"], c["table"][:, :pb])
        firsts.update(c["first"])
    assert set(firsts) == {id(r) for r in reqs}
    for r in reqs:
        assert r.out_tokens[0] == firsts[id(r)]
    rep = eng.metrics.report()
    assert rep["prefill_steps"] == len(calls)
    assert rep["prefill_computed_tokens"] == sum(
        c["tokens"][0] * c["tokens"][1] for c in calls)
    assert rep["prefill_row_use"] == pytest.approx(
        rep["prefill_chunk_tokens"] / rep["prefill_computed_tokens"])
    if scenario == "staggered_rows":
        # the call's width follows the advancing slots (one to three of the
        # four), down to the highest slot alone while lower slots decode
        assert {c["tokens"][0] for c in calls} == {1, 2, 3}
        assert any(c["chosen"] == [eng.pool.n_slots - 1] and c["decoding"]
                   and max(c["decoding"]) < c["chosen"][0] for c in calls)


def test_prefill_row_use_counts_the_padded_positions(model, monkeypatch):
    """``prefill_row_use`` is 1.0 when every chunk fills its bucket, and
    below 1.0 when a prompt's last chunk is short of it; the computed
    positions are rows x chunk bucket either way."""
    # 16, 24 and 8 tokens (BOS included): every chunk fills its bucket of 8
    eng, _, calls = _serve_spied(model, monkeypatch,
                                 ["a" * 15, "b" * 23, "c" * 7],
                                 prefill_slots=3)
    rep = eng.metrics.report()
    assert rep["prefill_chunk_tokens"] == 48
    assert rep["prefill_computed_tokens"] == 48 and rep["prefill_row_use"] == 1.0
    assert [c["tokens"] for c in calls] == [(3, 8), (2, 8), (1, 8)]
    monkeypatch.undo()
    # 16 and 21 tokens: the second prompt's last chunk is 5 of a bucket of 8
    eng, _, calls = _serve_spied(model, monkeypatch, ["a" * 15, "b" * 20],
                                 prefill_slots=2)
    rep = eng.metrics.report()
    assert rep["prefill_chunk_tokens"] == 37
    assert rep["prefill_computed_tokens"] == sum(
        r * cb for r, cb in (c["tokens"] for c in calls)) == 40
    assert rep["prefill_row_use"] == pytest.approx(37 / 40)


def test_fp_engine_streams_match_reference(model):
    prompts = ["hello", "paged serving"]
    jeng = JServeEngine(model["cfg"], model["jparams"], max_batch=2, s_max=32,
                        cache_dtype=jnp.float32)
    jreqs = [JRequest(p, max_new_tokens=5) for p in prompts]
    jeng.generate(jreqs)
    teng = ServeEngine(model["tcfg"], model["params"], max_batch=2, s_max=32,
                       cache_dtype=torch.float32, device="cpu")
    treqs = [Request(p, max_new_tokens=5) for p in prompts]
    teng.generate(treqs)
    assert teng.pool.mode == "fp"
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert ServeEngine.text(treqs[0]) == JServeEngine.text(jreqs[0])


def test_pool_alloc_share_cow_release(model):
    pool = PagePool(model["tcfg"], n_slots=2, s_max=32, page_size=8,
                    mode="int8", device="cpu")
    assert pool.pages_per_slot == 4 and pool.n_pages == 9 and pool.pages_free == 8
    assert pool.admit(0, 9)                        # 2 pages
    pool.kv["k"][:, pool.page_table[0, 1]] = 5
    assert pool.admit(1, 12, share_from=0, shared_pages=2)
    assert pool.pages_in_use == 2 and pool.share_count == 2
    assert pool.ensure_writable(1, 1) and pool.cow_count == 1
    new = pool.page_table[1, 1]
    assert new != pool.page_table[0, 1] and bool((pool.kv["k"][:, new] == 5).all())
    assert pool.release(0) == 1 and pool.release(1) == 2
    assert pool.pages_free == 8 and not pool.page_table.any()
    with pytest.raises(ValueError, match="pages_per_slot"):
        pool.admit(0, 33)
    # int4 pages (refused by the first slice): packed pages, bf16 scales
    # and [L, kvh, dh] redistribution rows, which copy-on-write leaves alone
    p4 = PagePool(model["tcfg"], 2, 16, page_size=8, mode="int4", device="cpu")
    L, kvh, dh = model["tcfg"].n_layers, model["tcfg"].n_kv_heads, 16
    assert p4.kv["k"].shape == (L, p4.n_pages, 8, kvh, dh // 2)
    assert p4.kv["k_scale"].dtype == torch.bfloat16
    assert p4.kv["k_redist"].shape == (L, kvh, dh)
    p4.kv["k_redist"][:, 1, 2] = 4.0
    redist = p4.kv["k_redist"].clone()
    assert p4.admit(0, 8) and p4.admit(1, 8, share_from=0, shared_pages=1)
    assert p4.ensure_writable(1, 0) and p4.cow_count == 1
    assert torch.equal(p4.kv["k_redist"], redist)
    assert p4.page_read_bytes() * 2 == PagePool(
        model["tcfg"], 2, 16, page_size=8, mode="int8",
        device="cpu").page_read_bytes()


def test_quant_ctx_refuses_unported_backends(model):
    """The fake backend (ported in the fifth slice) runs the site as the
    reference's QuantCtx does (f32 output within 1e-5 of its scale, on the
    bundle's static masks); a fused site without packed buffers still
    refuses."""
    art = QuantArtifact.load(model["path"])
    spec = {**FUSED, "backend": "fake"}
    ctx = QuantCtx(SitePolicy.uniform(QuantConfig(**spec)), device="cpu",
                   masks=art.masks)
    jctx = JQuantCtx(JSitePolicy.uniform(JQuantConfig(**spec)), masks=art.masks)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    x[:, HOT] *= 30.0
    w = rng.standard_normal((64, 8)).astype(np.float32)
    y = ctx("layer0/attn_qkv", torch.from_numpy(x), torch.from_numpy(w)).numpy()
    yj = np.asarray(jctx("layer0/attn_qkv", jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    assert ctx.backend_log == {"layer0/attn_qkv": "fake"}
    fused = QuantCtx(SitePolicy.uniform(QuantConfig(**FUSED)), device="cpu")
    with pytest.raises(RuntimeError, match="kernel buffers"):
        fused("layer0/attn_qkv", torch.zeros(1, 64), torch.zeros(64, 8))


def test_entry_points_run_on_the_card_by_default():
    """The port's entry points default to the card (``device="cuda"``); the
    CPU tests pass ``device="cpu"`` themselves."""
    import inspect

    from repro_torch.quantize import calibrate_model
    from repro_torch.serve.pool import PagePool as Pool

    for fn in (ServeEngine.__init__, QuantCtx.__init__, as_ctx, Pool.__init__,
               calibrate_model, T.init_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
