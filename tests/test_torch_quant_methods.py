"""The paper's quantization methods in the PyTorch port, held against the
JAX reference: quantizer primitives, MUXQ decomposition, the fake-quant
and real-int8 forms of every method of Table 1 (naive, MUXQ paper and
fused forms, LLM.int8(), SmoothQuant, MUXQ + SmoothQuant), offline
weight prequantization, and ``QuantCtx`` on the ``fake`` backend.

The same seeded numpy inputs go through both packages; the port runs on
CPU tensors.  Tolerances:
  * integer codes, scales and int32 accumulators: bit-equal;
  * f32 outputs: |port - ref| <= OUT_RTOL * max |ref| (only summation
    order differs between the frameworks' f32 matmuls);
  * SmoothQuant factors: within FACTOR_ULPS ulps at alpha 0.5, every
    policy's default (f32 ``pow``: the port takes the correctly rounded
    power, XLA's is an ulp off it for 0.07 % of inputs), within
    FACTOR_ULPS_OTHER at other alphas (XLA's f32 ``pow`` x^0.8 is up to 2
    ulps off the correctly rounded value for 40 % of inputs); exactly
    equal where they are compared as inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llm_int8 as JL8
from repro.core import muxq as JM
from repro.core import outliers as JO
from repro.core import prequant as JP
from repro.core import quantizers as JQ
from repro.core import smoothquant as JSQ
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.context import _prequant_matmul as j_prequant_matmul
from repro.core.policy import SitePolicy as JSitePolicy
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.synthetic import corpus as jcorpus
from repro.models.common import cross_entropy as jcross_entropy
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core import llm_int8 as L8
from repro_torch.core import muxq as M
from repro_torch.core import outliers as O
from repro_torch.core import prequant as P
from repro_torch.core import quantizers as Q
from repro_torch.core import smoothquant as SQ
from repro_torch.core.context import QuantCtx, _prequant_matmul
from repro_torch.core.policy import SitePolicy
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.data.synthetic import corpus
from repro_torch.models.common import cross_entropy

OUT_RTOL = 1e-5
FACTOR_ULPS = 2
FACTOR_ULPS_OTHER = 5

# (method, muxq_form): every method of the paper's Table 1 grid
METHODS = [("naive", "paper"), ("muxq", "paper"), ("muxq", "fused"),
           ("llm_int8", "paper"), ("smoothquant", "paper"),
           ("muxq_smooth", "paper"), ("muxq_smooth", "fused")]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, shape=(2, 7, 96), n=48, hot=(3, 40, 77)):
    """Activations with a few outlier channels (|x| > 6), a weight, a
    static mask naming them and a calibrated abs-max."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., list(hot)] *= 25.0
    w = (rng.standard_normal((shape[-1], n)) / np.sqrt(shape[-1])).astype(np.float32)
    mask = np.zeros(shape[-1], bool)
    mask[list(hot)] = True
    absmax = (np.abs(x).reshape(-1, shape[-1]).max(0) * 1.1).astype(np.float32)
    return x, w, mask, absmax


def _close(yt, yj):
    yt, yj = np.asarray(yt), np.asarray(yj)
    assert yt.shape == yj.shape and np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=OUT_RTOL * np.abs(yj).max())


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("gran", ["per_tensor", "per_token", "per_channel"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_primitives_match_reference(gran, bits):
    x, w, _, _ = _inputs(0)
    xi, s = Q.quantize(_t(x), bits, gran)
    jxi, js = JQ.quantize(jnp.asarray(x), bits, gran)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Q.fake_quant(_t(x), bits, gran).numpy(),
                                  np.asarray(JQ.fake_quant(jnp.asarray(x), bits, gran)))
    np.testing.assert_array_equal(
        Q.dequantize(xi, s).numpy(), np.asarray(JQ.dequantize(jxi, js)))
    assert float(Q.quant_error(_t(x), bits, gran)) == pytest.approx(
        float(JQ.quant_error(jnp.asarray(x), bits, gran)), rel=1e-6)


def test_int_matmul_exact_at_the_widest_served_k():
    """int8 x (int8 * 2^e) summed over K = 5632 (qwen2 mlp_down) exceeds
    f32's 24 bits; the port's product is the exact int32."""
    rng = np.random.default_rng(1)
    xi = rng.integers(-127, 128, (3, 5632)).astype(np.int32) * 4
    wi = rng.integers(-127, 128, (5632, 5)).astype(np.int8)
    xi[0], wi[:, 0] = 508, 127          # one sum of 5632 * 508 * 127
    exact = xi.astype(np.int64) @ wi.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    got = Q.int_matmul(_t(xi), _t(wi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.int_matmul(jnp.asarray(xi), jnp.asarray(wi))))


@pytest.mark.parametrize("agran,wgran", [("per_token", "per_channel"),
                                         ("per_tensor", "per_tensor")])
def test_quantized_matmul_matches_reference(agran, wgran):
    x, w, _, _ = _inputs(2)
    _close(Q.quantized_matmul(_t(x), _t(w), 8, 8, agran, wgran),
           JQ.quantized_matmul(jnp.asarray(x), jnp.asarray(w), 8, 8, agran, wgran))


def test_decompose_reconstruct_and_outlier_masks_match_reference():
    x, _, mask, _ = _inputs(3)
    for e in (1, 2, 3):
        body = M.decompose(_t(x), mask, e)
        np.testing.assert_array_equal(
            body.numpy(), np.asarray(JM.decompose(jnp.asarray(x), mask, e)))
        np.testing.assert_array_equal(
            M.reconstruct(body, mask, e).numpy(),
            np.asarray(JM.reconstruct(jnp.asarray(body.numpy()), mask, e)))
        np.testing.assert_array_equal(M.reconstruct(body, mask, e).numpy(), x)
    for thr in (2.0, 6.0):
        np.testing.assert_array_equal(
            O.outlier_mask(_t(x), thr).numpy(),
            np.asarray(JO.outlier_mask(jnp.asarray(x), thr)))
    np.testing.assert_array_equal(O.channel_absmax(_t(x)).numpy(),
                                  np.asarray(JO.channel_absmax(jnp.asarray(x))))
    for k in (0, 3, 10):
        np.testing.assert_array_equal(
            O.topk_outlier_mask(_t(x), k).numpy(),
            np.asarray(JO.topk_outlier_mask(jnp.asarray(x), k)))


def test_calibration_stats_save_load_across_packages(tmp_path):
    x, _, _, _ = _inputs(4)
    st, jst = O.CalibrationStats(), JO.CalibrationStats()
    for part in (x[0], x[1]):
        st.update("layer0/mlp_up", _t(part))
        jst.update("layer0/mlp_up", jnp.asarray(part))
    s = st.sites["layer0/mlp_up"]
    js = jst.sites["layer0/mlp_up"]
    np.testing.assert_array_equal(s.absmax, js.absmax)
    np.testing.assert_allclose(s.absmean, js.absmean, rtol=1e-6)
    assert s.count == js.count
    st.save(tmp_path / "port.npz")
    jst.save(str(tmp_path / "ref.npz"))
    for loaded in (JO.CalibrationStats.load(str(tmp_path / "port.npz")),
                   O.CalibrationStats.load(tmp_path / "ref.npz")):
        got = loaded.sites["layer0/mlp_up"]
        np.testing.assert_array_equal(got.absmax, s.absmax)
        assert got.count == s.count
        np.testing.assert_array_equal(loaded.masks()["layer0/mlp_up"],
                                      st.masks()["layer0/mlp_up"])


def test_smoothing_factors_within_ulps_of_reference():
    """Factors within FACTOR_ULPS ulps; the count of elements an ulp apart
    is stated, and applying either package's factors is exact in
    structure: (X/s) and (s*W) equal elementwise given the same s."""
    rng = np.random.default_rng(5)
    n_diff = n_all = 0
    for trial in range(20):
        a = (np.abs(rng.standard_normal(256)) * rng.uniform(0.1, 30)).astype(np.float32)
        w = (rng.standard_normal((256, 64)) * rng.uniform(0.01, 2)).astype(np.float32)
        for alpha in (0.5, 0.8):
            s = SQ.smoothing_factors(_t(a), _t(w), alpha).numpy()
            js = np.asarray(JSQ.smoothing_factors(jnp.asarray(a), jnp.asarray(w), alpha))
            assert _ulps(s, js).max() <= (FACTOR_ULPS if alpha == 0.5
                                          else FACTOR_ULPS_OTHER)
            if alpha == 0.5:
                n_diff += int((s != js).sum())
                n_all += s.size
    # at alpha 0.5 a small share of factors is an ulp apart (measured: about
    # 0.1 % of them): stated, not hidden; bundle tests count the codes
    # they move
    assert n_diff < 0.01 * n_all, (n_diff, n_all)
    x, w, _, absmax = _inputs(6)
    js = np.asarray(JSQ.smoothing_factors(jnp.asarray(absmax), jnp.asarray(w)))
    jx, jw = JSQ.apply_smoothing(jnp.asarray(x), jnp.asarray(w), jnp.asarray(absmax))
    xs = (_t(x) / _t(js)).numpy()
    np.testing.assert_array_equal(xs, np.asarray(jx))
    np.testing.assert_array_equal((_t(w) * _t(js)[:, None]).numpy(), np.asarray(jw))
    tx, tw = SQ.apply_smoothing(_t(x), _t(w), None)
    jx, jw = JSQ.apply_smoothing(jnp.asarray(x), jnp.asarray(w), None)
    _close(tx.numpy(), jx)
    _close(tw.numpy(), jw)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("gran", ["per_tensor", "per_token"])
@pytest.mark.parametrize("method,form", METHODS)
def test_qmatmul_matches_reference(method, form, gran, real, mode):
    """Every method x act granularity x real-int8 x mask mode: the output
    within OUT_RTOL of the reference's (static masks from calibration,
    dynamic ones from the live activation; smooth methods from the
    calibrated abs-max hint)."""
    x, w, mask, absmax = _inputs(7)
    kw = dict(method=method, muxq_form=form, act_granularity=gran,
              weight_granularity="per_channel" if gran == "per_token" else "per_tensor",
              real_int8=real, outlier_mode=mode)
    yt = M.qmatmul(_t(x), _t(w), M.QuantConfig(**kw), mask=_t(mask),
                   smooth=_t(absmax))
    yj = JM.qmatmul(jnp.asarray(x), jnp.asarray(w), JM.QuantConfig(**kw),
                    mask=jnp.asarray(mask), smooth=jnp.asarray(absmax))
    _close(yt.numpy(), yj)


@pytest.mark.parametrize("gran", ["per_tensor", "per_token"])
@pytest.mark.parametrize("form", ["paper", "fused"])
def test_muxq_codes_and_int32_accumulators_bit_equal(form, gran):
    """The real-int8 MUXQ forms' integer stage: Body codes and scale (and
    Aux codes for the paper form), weight codes, and the int32 products
    bit-equal to the reference's through its own primitives."""
    x, w, mask, _ = _inputs(8)
    cfg = dict(act_granularity=gran, weight_granularity="per_channel",
               muxq_form=form, real_int8=True)
    tc, jc = M.QuantConfig(**cfg), JM.QuantConfig(**cfg)
    body = M.decompose(_t(x), mask, tc.exp_factor)
    jbody = JM.decompose(jnp.asarray(x), mask, jc.exp_factor)
    bi, sb = Q.quantize(body, 8, gran)
    jbi, jsb = JQ.quantize(jbody, 8, gran)
    wi, _ = Q.quantize(_t(w), 8, "per_channel")
    jwi, _ = JQ.quantize(jnp.asarray(w), 8, "per_channel")
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    np.testing.assert_array_equal(wi.numpy(), np.asarray(jwi))
    if form == "fused":
        mult = np.where(mask, 2 ** tc.exp_factor, 1).astype(np.int32)
        jyi = JQ.int_matmul(jbi.astype(jnp.int32) * mult, jwi)
        _, _, _, _, yi = M.muxq_int32(_t(x), _t(w), tc, _t(mask))
        np.testing.assert_array_equal(yi.numpy(), np.asarray(jyi))
        assert np.abs(np.asarray(jyi)).max() > 0
    else:
        aux = torch.where(_t(mask), body, 0.0)
        ai, _ = Q.quantize(aux, 8, gran, scale=sb)
        jai, _ = JQ.quantize(jnp.where(mask, jbody, 0), 8, gran, scale=jsb)
        np.testing.assert_array_equal(ai.numpy(), np.asarray(jai))
        np.testing.assert_array_equal(Q.int_matmul(ai, wi).numpy(),
                                      np.asarray(JQ.int_matmul(jai, jwi)))
        np.testing.assert_array_equal(Q.int_matmul(bi, wi).numpy(),
                                      np.asarray(JQ.int_matmul(jbi, jwi)))


@pytest.mark.parametrize("real", [False, True])
def test_llm_int8_and_fake_quant_act_match_reference(real):
    x, w, mask, _ = _inputs(9)
    cfg = dict(act_granularity="per_token", weight_granularity="per_channel",
               real_int8=real)
    _close(L8.llm_int8_matmul(_t(x), _t(w), M.QuantConfig(**cfg), _t(mask)).numpy(),
           JL8.llm_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                               JM.QuantConfig(**cfg), jnp.asarray(mask)))
    for form in ("paper", "fused"):
        c = dict(muxq_form=form, act_granularity="per_tensor")
        np.testing.assert_array_equal(
            M.muxq_fake_quant_act(_t(x), M.QuantConfig(**c), _t(mask)).numpy(),
            np.asarray(JM.muxq_fake_quant_act(jnp.asarray(x), JM.QuantConfig(**c),
                                              jnp.asarray(mask))))


@pytest.fixture(scope="module")
def ref_model():
    """Reduced gpt2: the reference's config and init_params tree (numpy)."""
    from repro.configs import get_config as jget_config
    from repro.models import transformer as JT
    cfg = jget_config("gpt2-small", reduced=True)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, params


POLICIES = {
    "per_channel": M.QuantConfig(method="muxq", weight_granularity="per_channel"),
    "per_tensor_w4": M.QuantConfig(method="naive", weight_bits=4),
    "smooth": M.QuantConfig(method="muxq_smooth", weight_granularity="per_channel"),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_prequantize_params_matches_reference(ref_model, name):
    """Offline {"q", "s"} leaves bit-equal, smooth factors folded (the
    reference's factors given to both), fp sites and other leaves left
    alone; stacked back to the reference's layout."""
    cfg, params = ref_model
    tcfg = get_config("gpt2-small", reduced=True)
    policy = SitePolicy.uniform(POLICIES[name])
    jpolicy = JSitePolicy.from_json(policy.to_json())
    factors = {}
    if name == "smooth":
        rng = np.random.default_rng(10)
        for i in range(cfg.n_layers):
            for site, k in (("attn_qkv", 64), ("attn_out", 64), ("mlp_up", 64),
                            ("mlp_down", 256)):
                factors[f"layer{i}/{site}"] = rng.uniform(0.2, 5, k).astype(np.float32)
    jout = JP.prequantize_params(cfg, jax.tree.map(jnp.asarray, params),
                                 policy=jpolicy, smooth_factors=factors)
    tout = P.prequantize_params(tcfg, from_jax_params(tcfg, params, "cpu"),
                                policy=policy, smooth_factors=factors)
    ref = to_reference_layout(tout)
    for mod, key in (("attn", "wqkv"), ("attn", "wo"), ("mlp", "wi"), ("mlp", "wo")):
        for f in ("q", "s"):
            np.testing.assert_array_equal(ref["layers"][mod][key][f],
                                          np.asarray(jout["layers"][mod][key][f]),
                                          err_msg=f"{mod}/{key}/{f}")
    np.testing.assert_array_equal(ref["layers"]["mlp"]["bi"], params["layers"]["mlp"]["bi"])
    np.testing.assert_array_equal(ref["embed"], params["embed"])
    assert P.prequant_bytes(tout) < P.prequant_bytes(from_jax_params(tcfg, params, "cpu"))


def test_prequantize_refuses_layer_heterogeneous_and_unfoldable_policies(ref_model):
    cfg, params = ref_model
    tcfg = get_config("gpt2-small", reduced=True)
    tparams = from_jax_params(tcfg, params, "cpu")
    split = SitePolicy(default=M.QuantConfig(method="naive"),
                       rules=(("layer1/attn_out", M.QuantConfig(method="fp")),))
    with pytest.raises(ValueError, match="layer-heterogeneous"):
        P.prequantize_params(tcfg, tparams, policy=split)
    smooth = SitePolicy.uniform(M.QuantConfig(method="smoothquant"))
    with pytest.raises(ValueError, match="smooth factors"):
        P.prequantize_params(tcfg, tparams, policy=smooth, smooth_factors={})
    assert P.site_for_path("layers/mlp/wo") == JP.site_for_path("layers/mlp/wo") == "mlp_down"


@pytest.mark.parametrize("suffix", [
    "attn/wqkv", "attn/wo", "cross/wq", "cross/wkv", "cross/wo", "mlp/wi",
    "mlp/wo", "moe/wi", "moe/wo", "ssm/in_zx", "ssm/in_bcdt", "ssm/out_proj"])
def test_site_for_path_matches_reference(suffix):
    """The port's one site/leaf table names every eligible leaf's site as
    the reference's does, in each stack, and the shared expert's leaves
    (under ``moe/shared/``) none."""
    for root in ("layers", "enc_layers", "shared"):
        path = f"{root}/{suffix}"
        assert P.site_for_path(path) == JP.site_for_path(path) is not None
        assert P.site_for_path(path) in P.SITE_LEAF
        assert P.SITE_LEAF[P.site_for_path(path)] == tuple(suffix.split("/"))
    for key in ("wi", "wo"):
        assert P.site_for_path(f"layers/moe/shared/{key}") is None
        assert JP.site_for_path(f"layers/moe/shared/{key}") is None


@pytest.mark.parametrize("method", ["naive", "muxq", "muxq_smooth"])
@pytest.mark.parametrize("gran", ["per_tensor", "per_token"])
def test_prequant_matmul_matches_reference(method, gran):
    """x @ a prequantized leaf: the activation codes, the int32 product
    (the 2^e multiplier on masked channels) and the dequantized output."""
    x, w, mask, _ = _inputs(11)
    s = (np.abs(w).max(0, keepdims=True) / 127).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    cfg = dict(method=method, act_granularity=gran)
    yt = _prequant_matmul(_t(x), {"q": _t(q), "s": _t(s)}, M.QuantConfig(**cfg),
                          _t(mask))
    yj = j_prequant_matmul(jnp.asarray(x), {"q": jnp.asarray(q), "s": jnp.asarray(s)},
                           JM.QuantConfig(**cfg), jnp.asarray(mask))
    _close(yt.numpy(), yj)


@pytest.mark.parametrize("case", ["raw", "prequant", "smooth_raw",
                                  "smooth_prequant", "hint", "dynamic"])
def test_quant_ctx_fake_backend_matches_reference(case):
    """QuantCtx on the fake backend against the reference's QuantCtx at the
    same site: raw and {"q", "s"} weights, smooth sites with an artifact's
    folded factor (X/s, and s*W on a raw weight) or with only the
    calibrated abs-max hint, static and dynamic masks."""
    x, w, mask, absmax = _inputs(12)
    site = "layer0/mlp_up"
    method = "muxq_smooth" if case.startswith("smooth") or case == "hint" else "muxq"
    cfg = M.QuantConfig(method=method, act_granularity="per_token",
                        weight_granularity="per_channel",
                        outlier_mode="dynamic" if case == "dynamic" else "static")
    factor = np.asarray(JSQ.smoothing_factors(jnp.asarray(absmax), jnp.asarray(w)))
    state = dict(masks={site: mask}, smooths={site: absmax},
                 smooth_factors={site: factor} if case.startswith("smooth") else {})
    tctx = QuantCtx(SitePolicy.uniform(cfg), device="cpu", **state)
    jctx = JQuantCtx(JSitePolicy.from_json(SitePolicy.uniform(cfg).to_json()), **state)
    wt, wj = _t(w), jnp.asarray(w)
    if case.endswith("prequant"):
        w_fold = w * factor[:, None] if case.startswith("smooth") else w
        s = (np.abs(w_fold).max(0, keepdims=True) / 127).astype(np.float32)
        q = np.clip(np.round(w_fold / s), -127, 127).astype(np.int8)
        wt, wj = {"q": _t(q), "s": _t(s)}, {"q": jnp.asarray(q), "s": jnp.asarray(s)}
    _close(tctx(site, _t(x), wt).numpy(), jctx(site, jnp.asarray(x), wj))
    assert tctx.backend_log == {site: "fake"} == jctx.backend_log
    if case == "smooth_prequant":
        bare = QuantCtx(SitePolicy.uniform(cfg), device="cpu", masks={site: mask})
        with pytest.raises(RuntimeError, match="smooth factors"):
            bare(site, _t(x), wt)


def test_cross_entropy_and_pipeline_match_reference():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((2, 9, 384)).astype(np.float32) * 3
    labels = rng.integers(0, 300, (2, 9)).astype(np.int32)
    m = (rng.random((2, 9)) < 0.7).astype(np.float32)
    for mask in (None, m):
        got = cross_entropy(_t(logits), _t(labels), 300,
                            None if mask is None else _t(mask))
        want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), 300,
                              None if mask is None else jnp.asarray(mask))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    # the same generator calls: any prefix of a seed's corpus is equal
    text = corpus(2000, seed=1)
    assert text == jcorpus(2000, seed=1) and corpus(50) == jcorpus(50)
    for kw in (dict(seq_len=64, global_batch=2),
               dict(seq_len=32, global_batch=4, seed=1)):
        pipe = TokenPipeline(PipelineConfig(**kw), text=text)
        jpipe = JTokenPipeline(JPipelineConfig(**kw), text=text)
        for _ in range(3):
            b, jb = next(pipe), next(jpipe)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(b[key], jb[key])
        assert pipe.step == jpipe.step == 3
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(pipe.batch_at(7)[key],
                                          jpipe.batch_at(7)[key])
