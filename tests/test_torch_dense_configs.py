"""The reference's other dense decoders in the port: gemma2-9b (local and
global blocks with a window, attention and final softcaps, sandwich
norms, a scaled embedding), qwen2.5-14b and qwen1.5-110b (an untied LM
head, QKV bias) and internvl2-2b (a patch-embedding prefix), at their
REDUCED sizes, against the JAX reference on the CPU.

Both packages get the same weights: the reference's ``init_params`` tree,
with a few norm-gain channels and one K channel of ``wqkv`` scaled x20 so
that calibration finds activation and KV outliers, passed to the port
through ``convert.from_jax_params``.  Quantized serving runs the bundle
the reference's ``quantize_model`` wrote (fused MUXQ).  Tolerances:
forward logits within LOGIT_RTOL of their scale (f32; the frameworks sum
in other orders); streams and counters equal.  The port runs on CPU
tensors, i.e. through the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.core.policy import SitePolicy as JSitePolicy
from repro.models import transformer as JT
from repro.quantize import QuantArtifact as JQuantArtifact
from repro.quantize import quantize_model as jquantize_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core.muxq import QuantConfig
from repro_torch.core.policy import SitePolicy
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.quantize import QuantArtifact, quantize_model
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["gemma2-9b", "qwen2.5-14b", "qwen1.5-110b", "internvl2-2b"]
FUSED = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
             weight_granularity="per_channel", backend="fused")
HOT = [3, 17, 40]          # norm-gain channels scaled x20
LOGIT_RTOL = 1e-5          # forward logits, relative to max |logits|
PROMPTS = ["abc", "the paged pool serves", "x"]
COUNTERS = ("decode_steps", "prefill_chunks", "prefill_steps", "preemptions",
            "prefix_hits", "cow_copies", "prefills", "tokens_out",
            "spec_verify_steps", "spec_proposed", "spec_accepted",
            "cache_bytes", "bytes_per_token")


def _plant_outliers(cfg, params):
    for ln in ("ln1", "ln2"):
        params["layers"][ln]["gain"][:, HOT] = 19.0     # RMSNorm (1 + gain)
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
    art = jquantize_model(cfg, jparams, batches,
                          JSitePolicy.uniform(JQuantConfig(**FUSED)))
    path = tmp_path_factory.mktemp("bundle") / "art"
    art.save(str(path))
    tcfg = get_config(arch, reduced=True)
    return {"arch": arch, "cfg": cfg, "tcfg": tcfg, "params": params,
            "jparams": jparams, "tparams": from_jax_params(tcfg, params, "cpu"),
            "batches": batches, "art": art, "path": str(path)}


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    shared = ({f.name for f in dataclasses.fields(ModelConfig)}
              & {f.name for f in dataclasses.fields(jcfg)})
    assert {"n_patches", "sandwich_norm", "tie_embeddings", "window_size",
            "attn_softcap", "final_softcap", "scale_embed"} <= shared
    for name in sorted(shared):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.family, cfg.head_dim, cfg.padded_vocab, cfg.blocks) == (
        jcfg.family, jcfg.head_dim, jcfg.padded_vocab, jcfg.blocks)


def test_registry_lists_the_reference_order():
    archs = list_archs()
    assert archs == [a for a in jlist_archs() if a in archs]
    assert set(ARCHS) | {"qwen2-0.5b", "llama4-scout-17b-a16e",
                         "dbrx-132b"} == set(archs)
    assert "gpt2-small" not in archs and get_config("gpt2-small").n_layers == 12
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba2-370m")


# ---------------------------------------------------------------------------
# init_params, convert and the head
# ---------------------------------------------------------------------------

def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-0.5b", "gpt2-small"])
def test_init_params_tree_matches_reference(arch):
    """Names and shapes of the port's tree are the reference's (unstacked),
    sandwich norms and the untied head included; the head is scaled as
    the reference's ``dense_init`` (std 1/sqrt(d))."""
    cfg = get_config(arch, reduced=True)
    tp = T.init_params(cfg, seed=0, device="cpu")
    jp = jax.tree.map(np.asarray, JT.init_params(jget_config(arch, True),
                                                 jax.random.PRNGKey(0)))
    assert _shapes(to_reference_layout(tp)) == _shapes(jp)
    assert ("ln1b" in tp["layers"][0]) == cfg.sandwich_norm
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    if not cfg.tie_embeddings:
        std = float(tp["lm_head"].std())
        assert abs(std * np.sqrt(cfg.d_model) - 1.0) < 0.05
        assert abs(std - float(np.std(jp["lm_head"]))) < 0.05 * std


def test_init_params_refuses_other_families():
    cfg = get_config("qwen2-0.5b", reduced=True).replace(
        block_pattern=("mamba",))
    with pytest.raises(NotImplementedError, match="dense"):
        T.init_params(cfg, device="cpu")


def test_convert_round_trips_every_leaf(model):
    tp = model["tparams"]
    back = to_reference_layout(tp)
    jflat, tflat = _shapes(model["params"]), _shapes(back)
    assert jflat == tflat
    for path in jflat:
        a, b = model["params"], back
        for k in path.split("/"):
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_forward_logits_match_reference(model):
    cfg, tcfg = model["cfg"], model["tcfg"]
    tokens = model["batches"][0]["tokens"]
    lj = np.asarray(JT.forward(cfg, model["jparams"], jnp.asarray(tokens),
                               scan=False)["logits"])
    lt = T.forward(tcfg, model["tparams"], torch.as_tensor(tokens))[
        "logits"].numpy()
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    np.testing.assert_allclose(lt, lj, rtol=0,
                               atol=LOGIT_RTOL * np.abs(lj).max())
    if not tcfg.tie_embeddings:        # the head is lm_head, not embed^T
        tied = T.forward(tcfg.replace(tie_embeddings=True), model["tparams"],
                         torch.as_tensor(tokens))["logits"].numpy()
        assert np.abs(tied - lj).max() > 100 * LOGIT_RTOL * np.abs(lj).max()


def test_untied_config_without_lm_head_raises(model):
    tcfg = model["tcfg"]
    params = dict(model["tparams"])
    params.pop("lm_head", None)
    tokens = torch.zeros(1, 3, dtype=torch.long)
    if tcfg.tie_embeddings:
        tcfg = tcfg.replace(tie_embeddings=False)
    with pytest.raises(ValueError, match="lm_head"):
        T.forward(tcfg, params, tokens)


def test_patch_prefix_matches_reference():
    """internvl2: patch embeddings [b, n_patches, d] come before the token
    embeddings in ``forward``; logits over patches and tokens match."""
    arch = "internvl2-2b"
    cfg, tcfg = jget_config(arch, True), get_config(arch, True)
    assert tcfg.n_patches == 4
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6))
    patches = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    lj = np.asarray(JT.forward(cfg, jax.tree.map(jnp.asarray, params),
                               jnp.asarray(tokens), scan=False,
                               extra={"patches": jnp.asarray(patches)})
                    ["logits"])
    lt = T.forward(tcfg, from_jax_params(tcfg, params, "cpu"),
                   torch.as_tensor(tokens),
                   extra={"patches": torch.from_numpy(patches)})[
        "logits"].numpy()
    assert lt.shape == lj.shape == (2, cfg.n_patches + 6, cfg.padded_vocab)
    np.testing.assert_allclose(lt, lj, rtol=0,
                               atol=LOGIT_RTOL * np.abs(lj).max())
    plain = T.forward(tcfg, from_jax_params(tcfg, params, "cpu"),
                      torch.as_tensor(tokens))["logits"]
    assert plain.shape[1] == 6


# ---------------------------------------------------------------------------
# the engine, against the reference's
# ---------------------------------------------------------------------------

MODES = {"fp_engine": dict(quant=False, kv_mode="fp"),
         "fused_int8": dict(quant=True, kv_mode="int8"),
         "fused_fp": dict(quant=True, kv_mode="fp")}


def _serve_pair(model, quant, max_new=6, prompts=PROMPTS, **kw):
    common = dict(max_batch=3, s_max=48, prefill_chunk=8, **kw)
    jw = model["art"] if quant else model["jparams"]
    tw = QuantArtifact.load(model["path"]) if quant else model["params"]
    jeng = JServeEngine(model["cfg"], jw, cache_dtype=jnp.float32, **common)
    jreqs = [JRequest(p, max_new_tokens=max_new) for p in prompts]
    jeng.generate(jreqs)
    teng = ServeEngine(model["tcfg"], tw, cache_dtype=torch.float32,
                       device="cpu", **common)
    treqs = [Request(p, max_new_tokens=max_new) for p in prompts]
    teng.generate(treqs)
    return jeng, jreqs, teng, treqs


def _assert_same_serve(jeng, jreqs, teng, treqs):
    assert all(r.done and r.out_tokens for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])
    assert teng.decode_buckets == jeng.decode_buckets
    assert teng.prefill_buckets == jeng.prefill_buckets
    assert teng.verify_buckets == jeng.verify_buckets
    return trep


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_and_counters_match_reference(model, mode):
    """fp engine, fused MUXQ on int8 and on f32 pages: identical token
    streams, counters and bucket sets.  gemma2's sequences (up to 29
    positions) outrun its reduced window of 8, so its local layers' paged
    reads drop their first positions."""
    kw = dict(MODES[mode])
    quant = kw.pop("quant")
    _assert_same_serve(*_serve_pair(model, quant, **kw))


@pytest.mark.parametrize("model", ["gemma2-9b"], indirect=True)
def test_gemma2_int4_ngram_streams_match_reference(model):
    """gemma2 on int4 pages (its calibrated redistribution) with n-gram
    speculation (k 4, pages of 4): identical streams, counters, verify
    buckets."""
    prompts = ["abcabcabcabc", "the cat the cat the cat", "the cat sat",
               "xyzxyzxy"]
    pair = _serve_pair(model, True, max_new=10, prompts=prompts,
                       kv_mode="int4", spec_mode="ngram", spec_k=4,
                       page_size=4)
    trep = _assert_same_serve(*pair)
    assert trep["spec_verify_steps"] > 0 and trep["spec_accepted"] > 0
    assert float(pair[2].pool.kv["k_redist"].max()) > 1.0


def test_port_written_untied_bundle_serves_in_the_reference(tmp_path):
    """qwen2.5-14b: the port calibrates and writes a fused-MUXQ bundle; the
    reference loads it, with ``lm_head`` in full precision, and both
    engines serve it with the same streams and counters."""
    arch = "qwen2.5-14b"
    cfg, tcfg = jget_config(arch, True), get_config(arch, True)
    params = _plant_outliers(cfg, jax.tree.map(np.array, JT.init_params(
        cfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
               for _ in range(2)]
    art = quantize_model(tcfg, params, batches,
                         SitePolicy.uniform(QuantConfig(**FUSED)),
                         device="cpu")
    assert art.params["lm_head"].dtype == torch.float32
    art.save(tmp_path / "art")
    jart = JQuantArtifact.load(str(tmp_path / "art"))
    np.testing.assert_array_equal(np.asarray(jart.params["lm_head"]),
                                  params["lm_head"])
    common = dict(max_batch=3, s_max=48, prefill_chunk=8, kv_mode="int8")
    jeng = JServeEngine(cfg, jart, cache_dtype=jnp.float32, **common)
    jreqs = [JRequest(p, max_new_tokens=6) for p in PROMPTS]
    jeng.generate(jreqs)
    teng = ServeEngine(tcfg, QuantArtifact.load(tmp_path / "art"),
                       cache_dtype=torch.float32, device="cpu", **common)
    treqs = [Request(p, max_new_tokens=6) for p in PROMPTS]
    teng.generate(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_port_initialized_params(arch):
    """``init_params`` works for every arch: its tree serves (fp engine)."""
    cfg = get_config(arch, reduced=True)
    eng = ServeEngine(cfg, T.init_params(cfg, seed=1, device="cpu"),
                      max_batch=2, s_max=32, device="cpu")
    reqs = [Request("hello", max_new_tokens=3), Request("ab", max_new_tokens=3)]
    eng.generate(reqs)
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
