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


COUNTERS = ("decode_steps", "prefill_chunks", "prefill_steps", "preemptions",
            "prefix_hits", "cow_copies", "prefills", "tokens_out")

SCENARIOS = {
    # mixed prompt lengths, multi-chunk prefill interleaved with decode
    "mixed_int8": (dict(kv_mode="int8"),
                   ["abc", "the paged pool serves", "x", "long " * 9]),
    "mixed_fp": (dict(kv_mode="fp"),
                 ["abc", "the paged pool serves", "x", "long " * 9]),
    # shared prompt prefixes (prefix hits + copy-on-write) and a pool
    # small enough to preempt
    "shared_preempt": (dict(kv_mode="int8", page_size=4, n_pages=9),
                       ["shared prefix one", "shared prefix two", "shared pr",
                        "other"]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_streams_and_counters_match_reference(model, scenario):
    """ServeEngine on the reference-written bundle at f32: identical token
    streams and step/preemption/sharing counters."""
    kw, prompts = SCENARIOS[scenario]
    common = dict(max_batch=3, s_max=48, prefill_chunk=8, **kw)
    jeng = JServeEngine(model["cfg"], model["art"], cache_dtype=jnp.float32,
                        **common)
    jreqs = [JRequest(p, max_new_tokens=6) for p in prompts]
    jeng.generate(jreqs)
    teng = ServeEngine(model["tcfg"], QuantArtifact.load(model["path"]),
                       cache_dtype=torch.float32, device="cpu", **common)
    treqs = [Request(p, max_new_tokens=6) for p in prompts]
    teng.generate(treqs)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])
    assert teng.decode_buckets == jeng.decode_buckets
    assert teng.prefill_buckets == jeng.prefill_buckets
    if scenario == "shared_preempt":
        assert trep["prefix_hits"] > 0 and trep["preemptions"] > 0


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
    ctx = QuantCtx(SitePolicy.uniform(QuantConfig(**{**FUSED, "backend": "fake"})),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="fake"):
        ctx("layer0/attn_qkv", torch.zeros(1, 64), torch.zeros(64, 8))
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
