"""Parity of the port's int4 KV pages, KV calibration, dense forward and
speculative verify against the JAX reference, on the reduced gpt2 and
qwen2-0.5b configs (qwen2: GQA with 7 query heads over 1 KV head, RMSNorm,
SwiGLU).

Both packages get the same weights: the reference's ``init_params`` tree,
with a few norm-gain channels scaled x20 (activation outliers, so the
MUXQ masks are non-empty) and a few K-projection columns of ``wqkv``
scaled x20 (KV outliers, so the int4 redistribution masks are
non-empty).  The quantized artifact is a bundle the reference's
``QuantArtifact.save`` wrote.  The port runs on CPU tensors, i.e. through
the kernels' plain versions; the reference's paged kernel runs as its
jnp reference and in Pallas interpret mode.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.core.context import as_ctx as jas_ctx
from repro.core.policy import SitePolicy as JSitePolicy
from repro.kernels import paged_attention as JPA
from repro.models import transformer as JT
from repro.quantize import quantize_model
from repro.serve import kvq as jkvq
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.context import FpCtx, as_ctx
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import transformer as T
from repro_torch.quantize import QuantArtifact, calibrate_model
from repro_torch.serve import kvq, spec
from repro_torch.serve.engine import Request, ServeEngine

FUSED = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
             weight_granularity="per_channel", backend="fused")
HOT = [3, 17, 40]          # norm-gain channels scaled x20
LOGIT_ATOL = 1e-4          # f32 logits: op order differs between frameworks
ARCHS = ["gpt2-small", "qwen2-0.5b"]


def _plant_outliers(cfg, params):
    for ln in ("ln1", "ln2"):
        gain = params["layers"][ln]["gain"]
        if cfg.norm == "rmsnorm":
            gain[:, HOT] = 19.0                    # (1 + gain) = 20
        else:
            gain[:, HOT] *= 20.0
    # K outliers: channel 1 of KV head 0 (and its RoPE pair) x20
    k0 = cfg.n_heads * cfg.head_dim
    params["layers"]["attn"]["wqkv"][:, :, k0 + 1] *= 20.0
    return params


@pytest.fixture(scope="module", params=ARCHS)
def model(request, tmp_path_factory):
    arch = request.param
    cfg = jget_config(arch, reduced=True)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    params = _plant_outliers(cfg, params)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
               for _ in range(2)]
    jparams = jax.tree.map(jnp.asarray, params)
    art = quantize_model(cfg, jparams, batches,
                         JSitePolicy.uniform(JQuantConfig(**FUSED)))
    path = tmp_path_factory.mktemp("bundle") / "art"
    art.save(str(path))
    tcfg = get_config(arch, reduced=True)
    return {"cfg": cfg, "tcfg": tcfg, "params": params, "jparams": jparams,
            "tparams": from_jax_params(tcfg, params, "cpu"),
            "batches": batches, "art": art, "path": str(path)}


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


# ---------------------------------------------------------------------------
# Nibble packing and the int4 quantizer
# ---------------------------------------------------------------------------

def test_pack_unpack_int4_bit_equal_over_all_nibble_pairs():
    pairs = np.array(list(itertools.product(range(-8, 8), repeat=2)), np.int8)
    x = np.concatenate([pairs[:, :1], pairs[:, 1:]], axis=-1)   # lo | hi
    pj = np.asarray(jkvq.pack_int4(jnp.asarray(x)))
    pt = kvq.pack_int4(_t(x)).numpy()
    np.testing.assert_array_equal(pt, pj)
    assert len(np.unique(pt)) == 256                 # every byte appears once
    np.testing.assert_array_equal(kvq.unpack_int4(_t(pt)).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jkvq.unpack_int4(jnp.asarray(pt))), x)


@pytest.mark.parametrize("calibrated", [False, True])
def test_int4_quantizer_pages_and_scales_match_reference(calibrated):
    rng = np.random.default_rng(1)
    kvh, dh = 2, 16
    k = rng.standard_normal((3, 5, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((3, 5, kvh, dh)).astype(np.float32)
    k[..., 0, 4] *= 30.0
    v[..., 1, 9] *= 30.0
    calib = None
    if calibrated:
        mask = np.zeros((kvh, dh), bool)
        mask[0, 4] = mask[1, 9] = True
        calib = {"k_mask": mask, "v_mask": mask,
                 "exp_factor": np.asarray(3, np.int32)}
    jq = jkvq.make_quantizer("int4", kvh=kvh, dh=dh, calib=calib)
    tq = kvq.make_quantizer("int4", kvh=kvh, dh=dh, calib=calib)
    np.testing.assert_array_equal(tq.k_redist.numpy(), np.asarray(jq.k_redist))
    pj = jq.quantize(jnp.asarray(k), jnp.asarray(v))
    pt = tq.quantize(_t(k), _t(v))
    assert set(pt) == set(pj)
    for n in pt:
        np.testing.assert_array_equal(
            pt[n].float().numpy() if n.endswith("scale") else pt[n].numpy(),
            np.asarray(pj[n], np.float32) if n.endswith("scale") else np.asarray(pj[n]),
            err_msg=n)
    assert pt["k_scale"].dtype == torch.bfloat16 and pt["k"].shape[-1] == dh // 2
    kj, vj = jq.dequantize(pj, jnp.float32)
    kt, vt = tq.dequantize(pt, torch.float32)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for mode in kvq.KV_MODES:
        assert (kvq.make_quantizer(mode, kvh=kvh, dh=dh).bytes_per_token(kvh, dh)
                == jkvq.make_quantizer(mode, kvh=kvh, dh=dh).bytes_per_token(kvh, dh))


# ---------------------------------------------------------------------------
# Calibration through the port's dense forward
# ---------------------------------------------------------------------------

def test_dense_forward_logits_match_reference(model):
    cfg, tcfg = model["cfg"], model["tcfg"]
    tokens = model["batches"][0]["tokens"]
    lj = np.asarray(JT.forward(cfg, model["jparams"], jnp.asarray(tokens),
                               scan=False)["logits"])
    lt = T.forward(tcfg, model["tparams"], _t(tokens))["logits"]
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=LOGIT_ATOL)


def test_kv_calib_and_masks_match_reference_quantize_model(model):
    """``calibrate_model`` over the port's forward: KV amax within 1e-4
    relative, pooled KV outlier masks and matmul-site masks identical to
    the reference ``quantize_model``'s artifact."""
    stats, kv_calib = calibrate_model(model["tcfg"], model["tparams"],
                                      model["batches"], device="cpu")
    ref = model["art"].kv_calib
    assert set(kv_calib) == set(ref)
    for n in ("k_amax", "v_amax"):
        np.testing.assert_allclose(kv_calib[n], ref[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    for n in ("k_mask", "v_mask", "exp_factor"):
        np.testing.assert_array_equal(kv_calib[n], ref[n], err_msg=n)
    assert kv_calib["k_mask"].any(), "planted K outliers were not found"
    # the pooling rule itself, on the reference's stacked amax
    np.testing.assert_array_equal(
        kvq.pool_outlier_mask(ref["k_amax"]),
        jkvq.pool_outlier_mask(ref["k_amax"]))
    masks = stats.masks()
    assert set(masks) == set(model["art"].masks)
    for site, m in masks.items():
        np.testing.assert_array_equal(m, model["art"].masks[site], err_msg=site)


def test_convert_takes_the_reference_tree(model):
    """qwen2's tree (QKV bias, SwiGLU wi [d, 2 d_ff], RMSNorm gains only,
    tied embeddings) and gpt2's convert leaf for leaf."""
    cfg, tp = model["cfg"], model["tparams"]
    lp = tp["layers"][1]
    assert lp["mlp"]["wi"].shape == (cfg.d_model, (2 if cfg.mlp_type == "swiglu"
                                                   else 1) * cfg.d_ff)
    assert ("bias" in lp["ln1"]) == (cfg.norm == "layernorm")
    assert "lm_head" not in tp
    for mod, leaf in (("attn", "bqkv"), ("attn", "wqkv"), ("mlp", "wi"),
                      ("ln2", "gain")):
        np.testing.assert_array_equal(lp[mod][leaf].numpy(),
                                      model["params"]["layers"][mod][leaf][1])


# ---------------------------------------------------------------------------
# The int4 mode of paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,g", [(1, 1), (4, 1), (4, 3), (1, 7)])
def test_paged_attention_int4_plain_matches_reference_and_pallas(sq, g):
    """atol 1e-4 in f32 against ``paged_attention_ref`` and the Pallas
    kernel in interpret mode, with ragged tables (scratch page 0) and a
    non-identity redistribution row."""
    rng = np.random.default_rng(10 * sq + g)
    b, kvh, dh, ps, n_pages = 3, 2, 16, 4, 10
    h = kvh * g
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    k[..., 1, 5] *= 25.0
    mask = np.zeros((kvh, dh), bool)
    mask[1, 5] = True
    redist = kvq.redist_from_mask(mask)
    parts = jkvq.Int4KVQuantizer(redist, redist).quantize(jnp.asarray(k),
                                                          jnp.asarray(v))
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([4 * ps - sq, 5, 0], np.int32)
    jargs = (jnp.asarray(q), parts["k"], parts["v"], jnp.asarray(table),
             jnp.asarray(pos))
    jkw = dict(k_scale=parts["k_scale"], v_scale=parts["v_scale"],
               k_redist=jnp.asarray(redist), v_redist=jnp.asarray(redist))
    oref = np.asarray(JPA.paged_attention_ref(*jargs, **jkw))
    opal = np.asarray(JPA.paged_attention_pallas(*jargs, interpret=True, **jkw))
    ot = PA.paged_attention_decode(
        _t(q), _t(parts["k"]), _t(parts["v"]), _t(table), _t(pos),
        k_scale=_t(np.asarray(parts["k_scale"], np.float32)).to(torch.bfloat16),
        v_scale=_t(np.asarray(parts["v_scale"], np.float32)).to(torch.bfloat16),
        k_redist=_t(redist), v_redist=_t(redist))
    assert torch.isfinite(ot).all() and ot.shape == oref.shape
    np.testing.assert_allclose(ot.numpy(), oref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot.numpy(), opal, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Speculative verify step
# ---------------------------------------------------------------------------

def _pools(model, mode, calib):
    cfg, tcfg = model["cfg"], model["tcfg"]
    L, kvh, dh, n_pages, ps = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 9, 4
    jq = jkvq.make_quantizer(mode, kvh=kvh, dh=dh, dtype=jnp.float32,
                             calib=calib)
    jkv = jq.page_arrays(L, n_pages, ps, kvh, dh)
    jkv.update(jq.pool_state(L, kvh, dh))
    tq = kvq.make_quantizer(mode, kvh=kvh, dh=dh, dtype=torch.float32,
                            calib=calib)
    tkv = tq.page_arrays(L, n_pages, ps, kvh, dh, "cpu")
    tkv.update(tq.pool_state(L, kvh, dh, "cpu"))
    return jkv, tkv


@pytest.mark.parametrize("mode", ["fp", "int8", "int4"])
def test_decode_verify_paged_logits_match_reference(model, mode):
    """A 3-slot prefill chunk, then one verify block of k = 4 rows (slot 0
    crosses a page boundary, slot 1 has 3 valid rows, slot 2 is parked):
    f32 logits of every valid row within 1e-4.  fp pages run fp weights;
    int8 and int4 pages the reference-written fused-MUXQ bundle (int4 with
    its calibrated redistribution rows)."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    if mode == "fp":
        jctx, qparams = jas_ctx(None)
        jp, tctx, tp = model["jparams"], FpCtx(), model["tparams"]
        calib = None
    else:
        jctx, qparams = jas_ctx(model["art"])
        tart = QuantArtifact.load(model["path"])
        jp, tctx = model["art"].params, as_ctx(tart, "cpu")
        tp = from_jax_params(tcfg, tart.params, "cpu")
        calib = tart.kv_calib
        assert calib["k_mask"].any()
    jkv, tkv = _pools(model, mode, calib)
    rng = np.random.default_rng(3)
    C = 8
    toks = rng.integers(0, cfg.vocab_size, (3, C)).astype(np.int32)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    start = np.zeros(3, np.int32)
    w_hi = np.array([6, 5, 0], np.int32)
    _, jkv = JT.prefill_chunk_paged(
        cfg, jp, jnp.asarray(toks), jkv, jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(start), jnp.asarray(w_hi), jctx,
        qparams=qparams)
    T.prefill_chunk_paged(tcfg, tp, _t(toks), tkv, _t(table), _t(start),
                          _t(start), _t(w_hi), tctx)
    vt = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    pos, n_valid = np.array([6, 5, 0], np.int32), np.array([4, 3, 0], np.int32)
    lj, _ = JT.decode_verify_paged(
        cfg, jp, jnp.asarray(vt), jkv, jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(n_valid), jctx, qparams=qparams)
    lt, _ = T.decode_verify_paged(tcfg, tp, _t(vt), tkv, _t(table), _t(pos),
                                  _t(n_valid), tctx)
    lj, lt = np.asarray(lj), lt.numpy()
    assert lt.shape == lj.shape
    for slot in range(3):
        rows = slice(0, n_valid[slot])
        assert np.isfinite(lt[slot, rows]).all()
        np.testing.assert_allclose(lt[slot, rows], lj[slot, rows], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"slot {slot}")


def test_spec_proposer_and_acceptance_match_reference():
    from repro.serve import spec as jspec
    rng = np.random.default_rng(4)
    for _ in range(50):
        hist = list(rng.integers(0, 5, rng.integers(0, 20)))
        for k in (0, 1, 3):
            assert spec.propose_ngram(hist, k) == jspec.propose_ngram(hist, k)
        outs = list(rng.integers(0, 5, 4))
        assert spec.accept_length(hist[:3], outs) == jspec.accept_length(
            hist[:3], outs)


# ---------------------------------------------------------------------------
# The engine: int4 pages + n-gram speculation on the reference's bundle
# ---------------------------------------------------------------------------

COUNTERS = ("decode_steps", "prefill_chunks", "prefill_steps", "preemptions",
            "prefix_hits", "cow_copies", "prefills", "tokens_out",
            "spec_verify_steps", "spec_proposed", "spec_accepted",
            "decode_steps_saved", "cache_bytes", "bytes_per_token")
PROMPTS = ["abcabcabcabc", "the cat the cat the cat", "the cat sat",
           "xyzxyzxy"]


def test_engine_int4_spec_streams_and_counters_match_reference(model):
    """``kv_mode="int4"`` + ``spec_mode="ngram"`` at f32 on the reference's
    bundle, with page size 4 (k-token writes cross page boundaries) and
    prefix sharing: identical token streams, step and speculation
    counters, page bytes and verify buckets."""
    common = dict(max_batch=3, s_max=48, prefill_chunk=8, page_size=4,
                  kv_mode="int4", spec_mode="ngram", spec_k=4)
    jeng = JServeEngine(model["cfg"], model["art"], cache_dtype=jnp.float32,
                        **common)
    jreqs = [JRequest(p, max_new_tokens=10) for p in PROMPTS]
    jeng.generate(jreqs)
    teng = ServeEngine(model["tcfg"], QuantArtifact.load(model["path"]),
                       cache_dtype=torch.float32, device="cpu", **common)
    assert teng.pool.kv["k_redist"].max() > 1       # calibrated, not identity
    treqs = [Request(p, max_new_tokens=10) for p in PROMPTS]
    teng.generate(treqs)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])
    assert trep["spec_verify_steps"] > 0 and trep["prefix_hits"] > 0
    assert teng.verify_buckets == jeng.verify_buckets
    assert teng.decode_buckets == jeng.decode_buckets
    assert teng.prefill_buckets == jeng.prefill_buckets


def test_engine_spec_checks_match_reference(model):
    with pytest.raises(ValueError, match="spec_mode"):
        ServeEngine(model["tcfg"], model["params"], spec_mode="medusa",
                    device="cpu")
    eng = ServeEngine(model["tcfg"], model["params"], max_batch=1, s_max=16,
                      spec_mode="ngram", spec_k=1, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        eng.generate([Request("ab", max_new_tokens=2)])
