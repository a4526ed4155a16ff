"""The port writes the reference's artifact bundle: ``quantize_model`` ->
``QuantArtifact.save`` in ``repro_torch``, read by the JAX reference's
``QuantArtifact.load`` and served by either package's engine.

Reduced gpt2 and qwen2, the reference's ``init_params`` weights with a
few norm-gain channels (and one K channel) scaled x20 so calibration
finds outliers.  Two ways of comparing:
  * same precollected stats handed to both packages: masks, kernel
    buffers, {"q", "s"} leaves and ``scan_qparams`` bit-equal, policy and
    meta equal; smooth factors within FACTOR_ULPS ulps (the f32 ``pow``;
    see ``tests/test_torch_quant_methods.py``).  Where the port's own
    factors sit an ulp off, the weight codes they move are counted;
    packed with the reference's factors, everything is bit-equal;
  * each package calibrating for itself through its own f32 forward:
    act_absmax and kv_calib amax within CALIB_RTOL, masks equal except on
    channels whose abs-max lies within CALIB_RTOL of the threshold.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.policy import SitePolicy as JSitePolicy
from repro.models import transformer as JT
from repro.quantize import QuantArtifact as JQuantArtifact
from repro.quantize import _run_calibration
from repro.quantize import quantize_model as jquantize_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core import outliers as O
from repro_torch.core.muxq import QuantConfig
from repro_torch.core.policy import SitePolicy
from repro_torch.core.prequant import prequantize_params
from repro_torch.kernels import dispatch
from repro_torch.quantize import (QuantArtifact, _stack_qparams, build_artifact,
                                  load_artifact, pack_kernel_buffers,
                                  quantize_model)
from repro_torch.serve.engine import Request, ServeEngine

FACTOR_ULPS = 2
CALIB_RTOL = 1e-4
HOT = [3, 17, 40]
ARCHS = ["gpt2-small", "qwen2-0.5b"]

FUSED = QuantConfig(method="muxq", backend="fused", outlier_mode="static",
                    act_granularity="per_token", weight_granularity="per_channel")
POLICIES = {
    "fused_muxq": SitePolicy.uniform(FUSED),
    # fused MUXQ + SmoothQuant everywhere but attn_out (fake SmoothQuant,
    # per-tensor weights) and mlp_down (fake LLM.int8(), static masks)
    "mixed_smooth": SitePolicy(
        default=FUSED.replace(method="muxq_smooth"),
        rules=(("*attn_out", QuantConfig(method="smoothquant")),
               ("*mlp_down", QuantConfig(method="llm_int8", outlier_mode="static",
                                         act_granularity="per_token",
                                         weight_granularity="per_channel")))),
    "fake_muxq": SitePolicy.uniform(FUSED.replace(backend="fake")),
}
WEIGHTS = (("attn", "wqkv"), ("attn", "wo"), ("mlp", "wi"), ("mlp", "wo"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = jget_config(arch, reduced=True)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    for ln in ("ln1", "ln2"):
        gain = params["layers"][ln]["gain"]
        if cfg.norm == "rmsnorm":
            gain[:, HOT] = 19.0                    # (1 + gain) = 20
        else:
            gain[:, HOT] *= 20.0
    params["layers"]["attn"]["wqkv"][:, :, cfg.n_heads * cfg.head_dim + 1] *= 20.0
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
               for _ in range(2)]
    jparams = jax.tree.map(jnp.asarray, params)
    jstats, jkv = _run_calibration(cfg, jparams, batches, None)
    return {"cfg": cfg, "tcfg": get_config(arch, reduced=True), "params": params,
            "jparams": jparams, "batches": batches, "jstats": jstats, "jkv": jkv}


def _port_stats(jstats) -> O.CalibrationStats:
    st = O.CalibrationStats()
    for k, v in jstats.sites.items():
        st.sites[k] = O.ChannelStats(absmax=np.array(v.absmax),
                                     absmean=np.array(v.absmean), count=v.count)
    return st


def _jpolicy(policy):
    return JSitePolicy.from_json(policy.to_json())


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def _pair(model, tmp_path, name, pack_target):
    """(port bundle, reference bundle), both loaded by the reference."""
    policy = POLICIES[name]
    tart = quantize_model(model["tcfg"], model["params"],
                          _port_stats(model["jstats"]), policy,
                          pack_target=pack_target, device="cpu")
    jart = jquantize_model(model["cfg"], model["jparams"], model["jstats"],
                           _jpolicy(policy), pack_target=pack_target)
    tart.save(tmp_path / "port")
    jart.save(str(tmp_path / "ref"))
    return (JQuantArtifact.load(str(tmp_path / "port")),
            JQuantArtifact.load(str(tmp_path / "ref")), tart, jart)


def _flat(group):
    return ckpt.flatten(group) if group else {}


def _smooth_keys(policy, cfg):
    """Flat keys (params / kernel_buffers / scan_qparams) of the smooth-method
    sites, whose codes depend on the factors."""
    bases = {b for b in ("attn_qkv", "attn_out", "mlp_up", "mlp_down")
             if policy.resolve(f"layer0/{b}").method in ("smoothquant", "muxq_smooth")}
    paths = {"attn_qkv": "attn/wqkv", "attn_out": "attn/wo", "mlp_up": "mlp/wi",
             "mlp_down": "mlp/wo"}
    return lambda key: any(b in key or paths[b] in key for b in bases)


@pytest.mark.parametrize("pack_target", ["both", "fused", "tree"])
@pytest.mark.parametrize("name", ["fused_muxq", "mixed_smooth"])
def test_bundle_from_same_stats_equals_reference(model, tmp_path, name, pack_target):
    t, j, tart, jart = _pair(model, tmp_path, name, pack_target)
    assert t.policy.to_json() == j.policy.to_json()
    assert t.meta == j.meta and t.prequantized == j.prequantized
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == \
        json.loads((tmp_path / "ref" / "meta.json").read_text())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())
    for group in ("masks", "act_absmax", "kv_calib"):
        tg, jg = getattr(t, group), getattr(j, group)
        assert set(tg) == set(jg), group
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k], err_msg=f"{group}/{k}")
    assert set(t.smooth_factors) == set(j.smooth_factors)
    for k in j.smooth_factors:
        assert _ulps(t.smooth_factors[k], j.smooth_factors[k]).max() <= FACTOR_ULPS, k
    smooth = _smooth_keys(POLICIES[name], model["cfg"])
    moved = 0
    for group in ("params", "kernel_buffers", "scan_qparams"):
        tf, jf = _flat(getattr(t, group)), _flat(getattr(j, group))
        assert set(tf) == set(jf), group
        for k in jf:
            assert tf[k].dtype == jf[k].dtype and tf[k].shape == jf[k].shape, k
            if smooth(k) and not np.array_equal(tf[k], jf[k]):
                # the factors an ulp apart move a few codes and scales
                if tf[k].dtype == np.int8:
                    moved += int((tf[k] != jf[k]).sum())
                else:
                    assert _ulps(tf[k], jf[k]).max() <= FACTOR_ULPS, k
                continue
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{group}/{k}")
    n_codes = sum(v.size for k, v in _flat(j.params).items()
                  if v.dtype == np.int8 and smooth(k))
    # measured: 0 codes moved on both reduced models
    assert moved <= 1e-3 * max(n_codes, 1), (moved, n_codes)
    if pack_target == "fused":
        assert t.params["layers"]["attn"]["wqkv"]["q"].shape == (
            model["cfg"].n_layers, 1, 1)
    if pack_target == "tree":
        assert not t.kernel_buffers and t.policy.default.backend == "fake"


def test_packing_with_reference_factors_is_bit_exact(model):
    """The port's packers given the reference's smooth factors: the
    {"q", "s"} tree, the kernel buffers and the stacked scan qparams
    bit-equal to the reference's."""
    policy = POLICIES["mixed_smooth"]
    jart = jquantize_model(model["cfg"], model["jparams"], model["jstats"],
                           _jpolicy(policy))
    factors = {k: np.asarray(v) for k, v in jart.smooth_factors.items()}
    assert factors
    tparams = from_jax_params(model["tcfg"], model["params"], "cpu")
    packed = to_reference_layout(prequantize_params(
        model["tcfg"], tparams, policy=policy, smooth_factors=factors))
    bufs = pack_kernel_buffers(model["tcfg"], tparams, policy, jart.masks, factors)
    scan = _stack_qparams(model["tcfg"], jart.masks, factors, bufs)
    for mod, key in WEIGHTS:
        for f in ("q", "s"):
            np.testing.assert_array_equal(packed["layers"][mod][key][f],
                                          np.asarray(jart.params["layers"][mod][key][f]))
    assert set(bufs) == set(jart.kernel_buffers)
    for site, buf in bufs.items():
        for f in dispatch.BUFFER_FIELDS:
            np.testing.assert_array_equal(buf[f], jart.kernel_buffers[site][f],
                                          err_msg=f"{site}#{f}")
    assert _flat(scan).keys() == _flat(jart.scan_qparams).keys()
    for k, v in _flat(jart.scan_qparams).items():
        np.testing.assert_array_equal(_flat(scan)[k], v, err_msg=k)


def test_each_package_calibrates_for_itself(model):
    """quantize_model from the same params and batches, each package
    running its own calibration forwards."""
    policy = POLICIES["mixed_smooth"]
    tart = quantize_model(model["tcfg"], model["params"], model["batches"], policy,
                          device="cpu")
    jart = jquantize_model(model["cfg"], model["jparams"], model["batches"],
                           _jpolicy(policy))
    assert set(tart.act_absmax) == set(jart.act_absmax)
    thr = policy.default.outlier_threshold
    for site, jv in jart.act_absmax.items():
        np.testing.assert_allclose(tart.act_absmax[site], jv, rtol=CALIB_RTOL,
                                   atol=CALIB_RTOL, err_msg=site)
    assert set(tart.masks) == set(jart.masks)
    for site, jm in jart.masks.items():
        differ = tart.masks[site] != jm
        jv = jart.act_absmax[site]
        assert (np.abs(jv[differ] - thr) <= CALIB_RTOL * thr).all(), site
    assert any(m.any() for m in jart.masks.values())
    for k in ("k_amax", "v_amax"):
        np.testing.assert_allclose(tart.kv_calib[k], np.asarray(jart.kv_calib[k]),
                                   rtol=CALIB_RTOL, atol=CALIB_RTOL)
    for k in ("k_mask", "v_mask", "exp_factor", "outlier_ratio"):
        np.testing.assert_array_equal(tart.kv_calib[k], np.asarray(jart.kv_calib[k]))
    assert tart.kv_calib["k_mask"].any()


COUNTERS = ("decode_steps", "prefill_chunks", "prefill_steps", "preemptions",
            "prefix_hits", "cow_copies", "prefills", "tokens_out")
PROMPTS = ["abc", "the paged pool serves", "x", "long " * 9]


def _serve_both(model, path, **kw):
    common = dict(max_batch=3, s_max=48, prefill_chunk=8, kv_mode="fp", **kw)
    jeng = JServeEngine(model["cfg"], JQuantArtifact.load(str(path)),
                        cache_dtype=jnp.float32, **common)
    jreqs = [JRequest(p, max_new_tokens=6) for p in PROMPTS]
    jeng.generate(jreqs)
    teng = ServeEngine(model["tcfg"], load_artifact(path),
                       cache_dtype=torch.float32, device="cpu", **common)
    treqs = [Request(p, max_new_tokens=6) for p in PROMPTS]
    teng.generate(treqs)
    return jeng, jreqs, teng, treqs


@pytest.mark.parametrize("model,name,pack_target", [
    ("gpt2-small", "fused_muxq", "both"), ("gpt2-small", "fake_muxq", "both"),
    ("qwen2-0.5b", "mixed_smooth", "fused")], indirect=["model"])
def test_port_written_bundle_serves_identically_in_both_engines(
        model, tmp_path, name, pack_target):
    """A bundle the port calibrated and wrote, served by the reference's
    engine and by the port's (f32, fp pages): identical token streams and
    step/sharing counters.  ``fake_muxq`` serves every site on the fake
    backend from the prequantized {"q", "s"} tree."""
    art = quantize_model(model["tcfg"], model["params"], model["batches"],
                         POLICIES[name], pack_target=pack_target, device="cpu")
    art.save(tmp_path / "art")
    jeng, jreqs, teng, treqs = _serve_both(model, tmp_path / "art")
    assert all(r.done and r.out_tokens for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])
    backends = set(teng.ctx.backend_log.values())
    assert backends == ({"fake"} if name == "fake_muxq" else
                        {"fused", "fake"} if name == "mixed_smooth" else {"fused"})


def test_saving_a_loaded_bundle_with_another_pack_target(model, tmp_path):
    """A reference-written 'both' bundle, loaded by the port (stacked
    layout) and saved again with pack_target 'fused', equals the
    reference's own re-save."""
    jart = jquantize_model(model["cfg"], model["jparams"], model["jstats"],
                           _jpolicy(POLICIES["fused_muxq"]))
    jart.save(str(tmp_path / "both"))
    QuantArtifact.load(tmp_path / "both").save(tmp_path / "port", pack_target="fused")
    JQuantArtifact.load(str(tmp_path / "both")).save(str(tmp_path / "ref"),
                                                     pack_target="fused")
    t = JQuantArtifact.load(str(tmp_path / "port"))
    j = JQuantArtifact.load(str(tmp_path / "ref"))
    assert t.meta == j.meta == {"n_sites": j.meta["n_sites"],
                                "n_fused_sites": j.meta["n_fused_sites"],
                                "pack_target": "fused"}
    for group in ("params", "kernel_buffers", "scan_qparams", "masks"):
        tf, jf = _flat(getattr(t, group)), _flat(getattr(j, group))
        assert tf.keys() == jf.keys(), group
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{group}/{k}")


def test_build_artifact_keeps_no_full_size_weight_of_a_fused_site(model):
    """``build_artifact`` under a policy fused at every site but
    ``mlp_down``: each fused site's raw leaf is an inert [1, 1] stub (its
    kernel buffer carries the weight), ``mlp_down`` keeps its full weight
    (the fake backend reads it), the artifact serves the stream the
    unstubbed tree serves, and the caller's params stay as they were."""
    tcfg = model["tcfg"]
    params = from_jax_params(tcfg, model["params"], "cpu")
    before = [{mod: dict(lp[mod]) for mod in ("attn", "mlp")}
              for lp in params["layers"]]
    policy = SitePolicy(default=FUSED,
                        rules=(("*mlp_down", FUSED.replace(backend="fake")),))
    art = build_artifact(tcfg, params, policy,
                         _port_stats(model["jstats"]).masks())
    assert set(art.kernel_buffers) == {
        f"layer{i}/{b}" for i in range(tcfg.n_layers)
        for b in ("attn_qkv", "attn_out", "mlp_up")}
    for i, (lp, was) in enumerate(zip(art.params["layers"], before)):
        for mod, key in WEIGHTS:
            leaf, raw = lp[mod][key], was[mod][key]
            if (mod, key) == ("mlp", "wo"):
                assert leaf is raw
            else:
                assert leaf.shape == (1, 1) and leaf.dtype == raw.dtype
                assert not leaf.any(), (i, mod, key)
            assert params["layers"][i][mod][key] is raw, (i, mod, key)
            assert raw.shape[0] > 1 and raw.shape[1] > 1
    assert art.params["embed"] is params["embed"]
    streams = []
    for served in (art, dataclasses.replace(art, params=params)):
        eng = ServeEngine(tcfg, served, max_batch=3, s_max=48, prefill_chunk=8,
                          kv_mode="fp", cache_dtype=torch.float32, device="cpu")
        reqs = [Request(p, max_new_tokens=4) for p in PROMPTS]
        eng.generate(reqs)
        streams.append([r.out_tokens for r in reqs])
    assert all(streams[0]) and streams[0] == streams[1]


def test_save_bundle_is_atomic(tmp_path, monkeypatch):
    """A new bundle replaces the old one whole; a write that fails midway
    leaves the old bundle as it was and no temporary directory behind."""
    path = tmp_path / "b"
    ckpt.save_bundle(path, {"g": {"a": np.arange(3)}}, {"v": 1})
    ckpt.save_bundle(path, {"g": {"a": np.arange(4)}, "h": {"b": np.ones(2)}},
                     {"v": 2})
    groups, meta = ckpt.load_bundle(path, ["g", "h"])
    assert meta == {"v": 2} and groups["g"]["a"].tolist() == [0, 1, 2, 3]

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.np, "savez", fail)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_bundle(path, {"g": {"a": np.arange(9)}}, {"v": 3})
    monkeypatch.undo()
    groups, meta = ckpt.load_bundle(path, ["g", "h"])
    assert meta == {"v": 2} and groups["g"]["a"].tolist() == [0, 1, 2, 3]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["b"]


def test_quantize_model_refusals(model):
    with pytest.raises(ValueError, match="calibration"):
        quantize_model(model["tcfg"], model["params"], None, POLICIES["fused_muxq"],
                       device="cpu")
    with pytest.raises(ValueError, match="fused kernel"):
        quantize_model(model["tcfg"], model["params"], _port_stats(model["jstats"]),
                       FUSED.replace(method="llm_int8"), device="cpu")
    with pytest.raises(ValueError, match="pack_target"):
        quantize_model(model["tcfg"], model["params"], _port_stats(model["jstats"]),
                       FUSED, pack_target="half", device="cpu")
