"""The MoE family in the port: llama4-scout-17b-a16e (16 experts top-1 and
a shared expert) and dbrx-132b (16 experts top-4), at their REDUCED sizes
(4 experts; dbrx top-2), against the JAX reference on the CPU.

Both packages get the same weights: the reference's ``init_params`` tree
(or ``init_moe`` for one block), with a few norm-gain channels and one K
channel of ``wqkv`` scaled x20 so that calibration finds activation and
KV outliers, passed to the port through ``convert.from_jax_params``.
Inputs come from numpy seeds.  Tolerances: router dispatch (slots,
tokens, gates, keep) exact on the same probabilities; block outputs and
forward logits within RTOL of their scale (f32; the frameworks sum in
other orders, and the combine adds a token's k expert outputs in expert
order, as the reference's segment sum does); expert choices equal;
engine streams and counters equal.  The port runs on CPU tensors, i.e.
through the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.context import CollectCtx as JCollectCtx
from repro.core.context import FpCtx as JFpCtx
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.core.policy import SitePolicy as JSitePolicy
from repro.kernels import dispatch as jdispatch
from repro.models import moe as JE
from repro.models import transformer as JT
from repro.quantize import QuantArtifact as JQuantArtifact
from repro.quantize import quantize_model as jquantize_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core.context import CollectCtx, FpCtx, QuantCtx
from repro_torch.core.muxq import QuantConfig
from repro_torch.core.outliers import CalibrationStats, ChannelStats
from repro_torch.core.policy import SitePolicy
from repro_torch.kernels import dispatch
from repro_torch.models import moe as E
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.quantize import QuantArtifact, calibrate_model, quantize_model
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["llama4-scout-17b-a16e", "dbrx-132b"]
FUSED = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
             weight_granularity="per_channel", backend="fused")
HOT = [3, 17, 40]          # norm-gain channels scaled x20
RTOL = 1e-5                # block outputs and logits, relative to max |ref|
STAT_RTOL = 1e-5           # calibration absmax / absmean, relative
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


def _batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
            for _ in range(2)]


@pytest.fixture(scope="module", params=ARCHS)
def model(request, tmp_path_factory):
    arch = request.param
    cfg = jget_config(arch, reduced=True)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    params = _plant_outliers(cfg, params)
    batches = _batches(cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    art = jquantize_model(cfg, jparams, batches,
                          JSitePolicy.uniform(JQuantConfig(**FUSED)))
    path = tmp_path_factory.mktemp("bundle") / "art"
    art.save(str(path))
    tcfg = get_config(arch, reduced=True)
    return {"arch": arch, "cfg": cfg, "tcfg": tcfg, "params": params,
            "jparams": jparams, "tparams": from_jax_params(tcfg, params, "cpu"),
            "batches": batches, "art": art, "path": str(path)}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    shared = ({f.name for f in dataclasses.fields(ModelConfig)}
              & {f.name for f in dataclasses.fields(jcfg)})
    assert {"n_experts", "top_k", "shared_expert", "tie_embeddings"} <= shared
    for name in sorted(shared):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.family, cfg.head_dim, cfg.padded_vocab, cfg.blocks) == (
        jcfg.family, jcfg.head_dim, jcfg.padded_vocab, jcfg.blocks)
    assert cfg.family == "moe"


def test_init_params_tree_matches_reference():
    """Names, shapes and scales of the port's MoE tree are the reference's
    (the per-expert ``wi`` at the reference's fan-in, the expert count)."""
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        tp = to_reference_layout(T.init_params(cfg, seed=0, device="cpu"))
        jp = jax.tree.map(np.asarray, JT.init_params(jget_config(arch, True),
                                                     jax.random.PRNGKey(0)))
        assert jax.tree.map(np.shape, tp) == jax.tree.map(np.shape, jp)
        assert ("shared" in tp["layers"]["moe"]) == cfg.shared_expert
        for key in ("router", "wi", "wo"):
            a, b = tp["layers"]["moe"][key], jp["layers"]["moe"][key]
            assert abs(a.std() / b.std() - 1.0) < 0.1, key


# ---------------------------------------------------------------------------
# routing: capacity, dispatch, combine
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    """The port's capacity is the reference's dropless one."""
    for arch in ARCHS:
        cfg, jcfg = get_config(arch, True), jget_config(arch, True)
        for t in (1, 4, 8, 13, 32, 128):
            assert E._capacity(cfg, t) == JE._capacity(jcfg, t, None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [None, 1.25])
def test_dispatch_and_combine_match_reference(arch, factor):
    """Slots, tokens, gates and keep equal the reference's on the same
    probabilities, at the dropless capacity and at the reference's
    trainer capacity (factor 1.25, with drops); the buffer holds each kept
    assignment's token once; combine conserves sum_k gate_k * x."""
    cfg, jcfg = get_config(arch, True), jget_config(arch, True)
    rng = np.random.default_rng(7)
    t, d = 32, 16
    xf = rng.standard_normal((t, d)).astype(np.float32)
    logits = rng.standard_normal((t, cfg.n_experts)).astype(np.float32)
    logits[:, 0] += 2.0        # a hot expert: capacity 1.25 drops some
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    cap = JE._capacity(jcfg, t, factor)
    jout = JE._dispatch_group(jcfg, jnp.asarray(xf), jnp.asarray(probs), cap)
    tout = E._dispatch_group(cfg, torch.from_numpy(xf),
                             torch.from_numpy(probs), cap)
    for name, a, b in zip(("buf", "slot", "st", "gates", "keep"), tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    keep = tout[4].numpy()
    if factor is not None:
        assert not keep.all(), "capacity 1.25 should drop some assignment"
    counts = np.bincount(tout[1].numpy()[keep], minlength=cfg.n_experts * cap)
    assert counts.max() <= 1, "one assignment per slot"
    y = E._combine_group(tout[0], *tout[1:], t).numpy()
    yj = np.asarray(JE._combine_group(*jout, t))
    _close(y, yj)
    gates_per_token = np.zeros(t, np.float32)
    np.add.at(gates_per_token, tout[2].numpy(), tout[3].numpy() * keep)
    np.testing.assert_allclose(y, xf * gates_per_token[:, None], rtol=1e-5,
                               atol=1e-6)


def test_dispatch_ties_go_to_the_lower_expert():
    """Equal probabilities pick the lower expert index, as jax.lax.top_k."""
    cfg = get_config("dbrx-132b", True)
    probs = np.full((3, cfg.n_experts), 1.0 / cfg.n_experts, np.float32)
    probs[1, 2] = probs[1, 3] = 0.4
    xf = np.arange(3 * 8, dtype=np.float32).reshape(3, 8)
    tout = E._dispatch_group(cfg, torch.from_numpy(xf), torch.from_numpy(probs),
                             8)
    jout = JE._dispatch_group(jget_config("dbrx-132b", True), jnp.asarray(xf),
                              jnp.asarray(probs), 8)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = E._top_k(torch.from_numpy(probs), cfg.top_k)[1].tolist()
    assert idx == [[0, 1], [2, 3], [0, 1]]


def test_grouped_equals_flat_at_one_group():
    """b = 1 grouped dispatch (s > 1) equals the flat path (s == 1)."""
    for arch in ARCHS:
        cfg = get_config(arch, True)
        p = T.init_params(cfg, seed=3, device="cpu")["layers"][0]["moe"]
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, 16, cfg.d_model)).astype(np.float32))
        yg, auxg = E.moe(cfg, p, FpCtx(), x)
        yf, auxf = E.moe(cfg, p, FpCtx(), x.reshape(16, 1, cfg.d_model))
        np.testing.assert_allclose(yg.reshape(16, -1).numpy(),
                                   yf.reshape(16, -1).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert float(auxg) == pytest.approx(float(auxf), rel=1e-6)


# ---------------------------------------------------------------------------
# the block on every ctx
# ---------------------------------------------------------------------------

def _block_inputs(arch, b, s, seed=0):
    cfg, jcfg = get_config(arch, True), jget_config(arch, True)
    p = jax.tree.map(np.asarray, JE.init_moe(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    x[..., HOT] *= 20.0
    return cfg, jcfg, p, x


def _block_masks(cfg, p):
    """Static masks on the planted channels (d inputs) and on the hidden
    channels whose up-projection columns are largest (f inputs)."""
    md = np.zeros(cfg.d_model, bool)
    md[HOT] = True
    mf = np.zeros(cfg.d_ff, bool)
    mf[np.argsort(-np.abs(p["wi"]).max(axis=(0, 1))[: cfg.d_ff])[:4]] = True
    return {"moe_up": md, "moe_down": mf, "mlp_up": md, "mlp_down": mf}


def _block_ctxs(cfg, jcfg, p, kind):
    if kind == "fp":
        return FpCtx(), JFpCtx()
    masks = _block_masks(cfg, p)
    spec = dict(FUSED, backend=kind)
    if kind == "fake":
        return (QuantCtx(QuantConfig(**spec), device="cpu", masks=masks),
                JQuantCtx(JQuantConfig(**spec), masks=masks))
    weights = {"moe_up": p["wi"], "moe_down": p["wo"]}
    if cfg.shared_expert:
        weights.update(mlp_up=p["shared"]["wi"], mlp_down=p["shared"]["wo"])
    tb = {s: dispatch.pack_site_buffer(torch.from_numpy(w), masks[s],
                                       QuantConfig(**spec), bk=32)
          for s, w in weights.items()}
    jb = {s: jdispatch.pack_site_buffer(jnp.asarray(w), masks[s],
                                        JQuantConfig(**spec), bk=32)
          for s, w in weights.items()}
    for s in tb:
        for f in dispatch.BUFFER_FIELDS:
            np.testing.assert_array_equal(tb[s][f], np.asarray(jb[s][f]))
    return (QuantCtx(QuantConfig(**spec), device="cpu", masks=masks,
                     kernel_buffers=tb),
            JQuantCtx(JQuantConfig(**spec), masks=masks, kernel_buffers=jb))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["fp", "fake", "fused"])
@pytest.mark.parametrize("shape", [(2, 8), (6, 1)], ids=["grouped", "flat"])
def test_moe_block_matches_reference(arch, kind, shape):
    """The block on FpCtx, the fake MUXQ ctx and the fused ctx (the
    reference's fused emm is its oracle form; the port's runs its plain
    kernel versions, one quantize over all experts' rows and a GEMM per
    expert, and under ``set_fused_impl("ref")`` the oracle form too):
    outputs within RTOL, aux loss within 1e-6."""
    cfg, jcfg, p, x = _block_inputs(arch, *shape)
    ctx, jctx = _block_ctxs(cfg, jcfg, p, kind)
    tp = from_jax_params(None, {"layers": {"moe": jax.tree.map(
        lambda a: a[None], p)}}, "cpu")["layers"][0]["moe"]
    yj, auxj = JE.moe(jcfg, jax.tree.map(jnp.asarray, p), jctx, jnp.asarray(x))
    y, aux = E.moe(cfg, tp, ctx, torch.from_numpy(x))
    _close(y.numpy(), yj)
    assert float(aux) == pytest.approx(float(auxj), rel=1e-6)
    if kind != "fp":
        sites = {"moe_up", "moe_down"} | ({"mlp_up", "mlp_down"}
                                          if cfg.shared_expert else set())
        assert ctx.backend_log == {s: kind for s in sites}
    if kind == "fused":
        prev = dispatch.set_fused_impl("ref")
        try:
            y_ref, _ = E.moe(cfg, tp, ctx, torch.from_numpy(x))
        finally:
            dispatch.set_fused_impl(prev)
        torch.testing.assert_close(y_ref, y, rtol=0, atol=0)


def test_fake_emm_on_prequantized_and_smoothed_weights():
    """The fake emm on per-expert {"q", "s"} leaves and with a smoothing
    divisor folded (``factor`` over the rows of every expert) matches the
    reference's vmap over experts."""
    cfg, jcfg, p, x = _block_inputs("dbrx-132b", 1, 8, seed=2)
    rng = np.random.default_rng(3)
    xe = rng.standard_normal((cfg.n_experts, 8, cfg.d_model)).astype(np.float32)
    xe[..., HOT] *= 20.0
    mask = _block_masks(cfg, p)["moe_up"]
    factor = rng.uniform(0.5, 2.0, cfg.d_model).astype(np.float32)
    for method in ("muxq", "muxq_smooth"):
        spec = dict(FUSED, backend="fake", method=method)
        kw = dict(masks={"moe_up": mask},
                  smooth_factors={"moe_up": factor} if "smooth" in method else {})
        ctx = QuantCtx(QuantConfig(**spec), device="cpu", **kw)
        jctx = JQuantCtx(JQuantConfig(**spec), **kw)
        w = p["wi"]
        if "smooth" in method:
            w = w * factor[None, :, None]
        s = np.max(np.abs(w), axis=-2, keepdims=True) / 127.0
        q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        for leaf, jleaf in (
                (torch.from_numpy(p["wi"]), jnp.asarray(p["wi"])),
                ({"q": torch.from_numpy(q), "s": torch.from_numpy(s)},
                 {"q": jnp.asarray(q), "s": jnp.asarray(s)})):
            y = ctx.emm("moe_up", torch.from_numpy(xe), leaf).numpy()
            yj = jctx.emm("moe_up", jnp.asarray(xe), jleaf)
            _close(y, yj)


# ---------------------------------------------------------------------------
# the whole model: forward, expert choices, calibration, packing, bundles
# ---------------------------------------------------------------------------

def _expert_choices(monkeypatch, run, module, to_np):
    """Run ``run()`` with ``module.moe`` wrapped to record each call's
    input; returns the recorded inputs as numpy arrays."""
    seen = []
    orig = module.moe

    def spy(cfg, p, ctx, x, *a, **kw):
        seen.append((to_np(x), to_np(p["router"])))
        return orig(cfg, p, ctx, x, *a, **kw)
    monkeypatch.setattr(module, "moe", spy)
    out = run()
    monkeypatch.setattr(module, "moe", orig)
    return out, seen


def test_forward_logits_and_expert_choices_match_reference(model, monkeypatch):
    """Forward logits within RTOL of their scale and the aux loss within
    1e-5; at every layer each token's experts equal the reference's (the
    smallest gap between a token's k-th and (k+1)-th probability is
    printed: a near-tie there is where the frameworks' f32 router sums
    could part)."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    tokens = model["batches"][0]["tokens"]
    jout, jseen = _expert_choices(
        monkeypatch, lambda: JT.forward(cfg, model["jparams"],
                                        jnp.asarray(tokens), scan=False),
        JE, np.asarray)
    tout, tseen = _expert_choices(
        monkeypatch, lambda: T.forward(tcfg, model["tparams"],
                                       torch.as_tensor(tokens)),
        E, lambda t: t.detach().numpy())
    _close(tout["logits"].numpy(), jout["logits"])
    assert float(tout["aux"]) == pytest.approx(float(jout["aux"]), rel=1e-5)
    assert len(tseen) == len(jseen) == cfg.n_layers
    min_gap = np.inf
    for (xt, rt), (xj, rj) in zip(tseen, jseen):
        _close(xt, xj)
        pt = torch.softmax(torch.from_numpy(xt) @ torch.from_numpy(rt), -1)
        pj = jax.nn.softmax(jnp.asarray(xj) @ jnp.asarray(rj), -1)
        it = E._top_k(pt, cfg.top_k)[1].numpy()
        ij = np.asarray(jax.lax.top_k(pj, cfg.top_k)[1])
        np.testing.assert_array_equal(it, ij)
        srt = np.sort(np.asarray(pj), -1)[..., ::-1]
        min_gap = min(min_gap, float((srt[..., cfg.top_k - 1]
                                      - srt[..., cfg.top_k]).min()))
    print(f"{model['arch']}: expert choices equal; smallest top-k gap "
          f"{min_gap:.3e}")


def test_collect_ctx_stats_match_reference(model):
    """Calibration through each package's forward: the same sites (the
    expert sites' whole dispatch buffer, zero padding rows included), with
    absmax and absmean within STAT_RTOL and equal counts."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    jctx, tctx = JCollectCtx(), CollectCtx()
    for batch in model["batches"]:
        JT.forward(cfg, model["jparams"], jnp.asarray(batch["tokens"]), jctx,
                   scan=False)
        T.forward(tcfg, model["tparams"], torch.as_tensor(batch["tokens"]),
                  tctx)
    js, ts = jctx.stats.sites, tctx.stats.sites
    assert set(ts) == set(js)
    assert {"layer0/moe_up", "layer1/moe_down"} <= set(ts)
    assert ("layer0/mlp_up" in ts) == tcfg.shared_expert
    for site in js:
        assert ts[site].count == js[site].count, site
        for stat in ("absmax", "absmean"):
            np.testing.assert_allclose(getattr(ts[site], stat),
                                       getattr(js[site], stat),
                                       rtol=STAT_RTOL, atol=1e-7,
                                       err_msg=f"{site} {stat}")
    # the expert buffer's padding rows are counted: rows = e * cap per group
    t = model["batches"][0]["tokens"].shape[1]
    cap = E._capacity(tcfg, t)
    assert ts["layer0/moe_up"].count == 2 * 2 * tcfg.n_experts * cap


def test_fused_expert_buffers_equal_reference(model):
    """The port's ``quantize_model`` on the same precollected stats packs
    every fused site the reference packs, the expert sites [E, K_pad, N],
    the shared expert's from ``moe/shared`` under ``layer{i}/mlp_*``, bit
    for bit; the scan stacks name the shared expert ``moe_shared_*``."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    jctx = JCollectCtx()
    for batch in model["batches"]:
        JT.forward(cfg, model["jparams"], jnp.asarray(batch["tokens"]), jctx,
                   scan=False)
    stats = CalibrationStats()
    stats.sites = {k: ChannelStats(v.absmax, v.absmean, v.count)
                   for k, v in jctx.stats.sites.items()}
    policy = SitePolicy.uniform(QuantConfig(**FUSED))
    art = quantize_model(tcfg, model["params"], stats, policy, device="cpu")
    jart = jquantize_model(cfg, model["jparams"], jctx.stats,
                           JSitePolicy.uniform(JQuantConfig(**FUSED)))
    assert set(art.kernel_buffers) == set(jart.kernel_buffers)
    assert art.kernel_buffers["layer0/moe_up"]["w_int"].ndim == 3
    assert art.kernel_buffers["layer0/moe_up"]["sw"].shape == (
        tcfg.n_experts, 1, 2 * tcfg.d_ff)
    for site, buf in jart.kernel_buffers.items():
        for f in dispatch.BUFFER_FIELDS:
            np.testing.assert_array_equal(art.kernel_buffers[site][f],
                                          np.asarray(buf[f]),
                                          err_msg=f"{site} {f}")
    assert set(art.scan_qparams) == set(jart.scan_qparams)
    if tcfg.shared_expert:
        assert "moe_shared_up@fused" in art.scan_qparams
    for key, val in jart.scan_qparams.items():
        tv = art.scan_qparams[key]
        for f in (val if isinstance(val, dict) else {None: val}):
            a = tv[f] if f else tv
            b = val[f] if f else val
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{key} {f}")
    # the {"q", "s"} tree: expert leaves per expert, the shared expert raw
    tq = to_reference_layout(art.params)
    jq = jax.tree.map(np.asarray, jart.params)
    for key in ("wi", "wo"):
        for f in ("q", "s"):
            np.testing.assert_array_equal(tq["layers"]["moe"][key][f],
                                          jq["layers"]["moe"][key][f])
    if tcfg.shared_expert:
        assert not isinstance(tq["layers"]["moe"]["shared"]["wi"], dict)


# ---------------------------------------------------------------------------
# the engine, against the reference's
# ---------------------------------------------------------------------------

def _serve_pair(model, jw, tw, max_new=6, prompts=PROMPTS, **kw):
    common = dict(max_batch=3, s_max=48, prefill_chunk=8, **kw)
    jeng = JServeEngine(model["cfg"], jw, cache_dtype=jnp.float32, **common)
    jreqs = [JRequest(p, max_new_tokens=max_new) for p in prompts]
    jeng.generate(jreqs)
    teng = ServeEngine(model["tcfg"], tw, cache_dtype=torch.float32,
                       device="cpu", **common)
    treqs = [Request(p, max_new_tokens=max_new) for p in prompts]
    teng.generate(treqs)
    assert all(r.done and r.out_tokens for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    for c in COUNTERS:
        assert trep[c] == jrep[c], (c, trep[c], jrep[c])
    assert teng.decode_buckets == jeng.decode_buckets
    assert teng.prefill_buckets == jeng.prefill_buckets
    assert teng.verify_buckets == jeng.verify_buckets
    return teng, trep


@pytest.mark.parametrize("mode", ["fp_engine", "fused_int8"])
def test_engine_streams_and_counters_match_reference(model, mode):
    """fp engine on f32 pages, and the reference-written fused MUXQ bundle
    on int8 pages: identical token streams, counters and bucket sets."""
    if mode == "fp_engine":
        teng, _ = _serve_pair(model, model["jparams"], model["params"],
                              kv_mode="fp")
    else:
        teng, _ = _serve_pair(model, model["art"],
                              QuantArtifact.load(model["path"]),
                              kv_mode="int8")
        assert teng.ctx.backend_log["layer0/moe_up"] == "fused"
        assert teng.ctx.kernel_buffers["layer0/moe_down"]["w_int"].ndim == 3


@pytest.mark.parametrize("model", ["dbrx-132b"], indirect=True)
def test_dbrx_int4_ngram_streams_match_reference(model):
    """dbrx on int4 pages (its calibrated redistribution) with n-gram
    speculation (k 4, pages of 4): verify and prefill run the grouped
    dispatch, decode the flat one; identical streams, counters, buckets."""
    # prompts whose greedy streams repeat, so that drafts are accepted too
    prompts = ["hello hello hello", "one two one two one two", "abcabc",
               "zzzz"]
    teng, trep = _serve_pair(model, model["art"],
                             QuantArtifact.load(model["path"]), max_new=16,
                             prompts=prompts, kv_mode="int4",
                             spec_mode="ngram", spec_k=4, page_size=4)
    assert trep["spec_verify_steps"] > 0 and trep["spec_accepted"] > 0
    assert float(teng.pool.kv["k_redist"].max()) > 1.0


@pytest.mark.parametrize("model", ["llama4-scout-17b-a16e"], indirect=True)
def test_port_written_bundle_serves_in_the_reference(model, tmp_path):
    """llama4: the port calibrates through its own forward and writes a
    fused-MUXQ bundle (pack target ``fused``: the expert leaves stubbed,
    the shared expert's raw leaves kept); the reference loads it and both
    engines serve it with the same streams and counters."""
    tcfg = model["tcfg"]
    art = quantize_model(tcfg, model["params"], model["batches"],
                         SitePolicy.uniform(QuantConfig(**FUSED)),
                         pack_target="fused", device="cpu")
    assert {"layer0/moe_up", "layer1/mlp_down"} <= set(art.kernel_buffers)
    art.save(tmp_path / "art")
    jart = JQuantArtifact.load(str(tmp_path / "art"))
    moe_tree = jart.params["layers"]["moe"]
    assert np.asarray(moe_tree["wi"]["q"]).shape == (tcfg.n_layers, 1, 1, 1)
    np.testing.assert_array_equal(np.asarray(moe_tree["shared"]["wi"]),
                                  model["params"]["layers"]["moe"]["shared"]["wi"])
    _serve_pair(model, jart, QuantArtifact.load(tmp_path / "art"),
                kv_mode="int8")


def test_calibration_masks_match_reference(model):
    """Each package calibrating for itself: the same masks at every site
    (the expert sites' included) and the KV calibration's outlier masks."""
    stats, kv = calibrate_model(model["tcfg"], model["tparams"],
                                model["batches"], device="cpu")
    jart = model["art"]
    for site, m in jart.masks.items():
        np.testing.assert_array_equal(stats.sites[site].mask(), m,
                                      err_msg=site)
    for key in ("k_mask", "v_mask"):
        np.testing.assert_array_equal(kv[key], jart.kv_calib[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_port_initialized_params(arch):
    """``init_params`` works for both MoE archs: its tree serves (fp)."""
    cfg = get_config(arch, reduced=True)
    eng = ServeEngine(cfg, T.init_params(cfg, seed=1, device="cpu"),
                      max_batch=2, s_max=32, device="cpu")
    reqs = [Request("hello", max_new_tokens=3), Request("ab", max_new_tokens=3)]
    eng.generate(reqs)
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)


def test_engine_refuses_a_fused_policy_without_buffers():
    cfg = get_config("dbrx-132b", reduced=True)
    with pytest.raises(ValueError, match="packed kernel buffers"):
        ServeEngine(cfg, T.init_params(cfg, device="cpu"), device="cpu",
                    quant=SitePolicy.uniform(QuantConfig(**FUSED)))
