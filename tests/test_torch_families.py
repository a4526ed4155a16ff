"""The SSM, hybrid and encoder-decoder families in the port: mamba2-370m,
zamba2-1.2b and whisper-tiny at their REDUCED sizes, against the JAX
reference on the CPU.

Both packages get the same weights (the reference's ``init_params``
tree, with three ``ln1`` gain channels of the decoder stack set to 20 so
that calibration finds outliers, passed to the port through
``convert.from_jax_params``) and the same seeded numpy inputs (whisper's
frames too).  The reference runs eagerly (``scan=False``: its scanned
prefill cannot run the fused encoder) with ``set_fused_impl("ref")``;
the port runs on CPU tensors, i.e. through the kernels' plain versions.
Tolerances:
  * ``ssd_chunked``, ``ssm_block``, ``ssm_decode``, ``cross_attention``,
    forward and decode logits: within RTOL of the reference's scale (f32;
    the frameworks sum einsums, softplus and the conv in other orders);
    against the naive recurrence, SSD_TOL (the recurrence's f32 sums run
    step by step);
  * decode against the port's own forward: DECODE_TOL of its scale;
  * packed buffers, scan stacks and the {"q", "s"} tree from the same
    stats: bit-equal; token streams: equal;
  * ``lm_loss`` within LOSS_RTOL relative, each gradient leaf within
    GRAD_TOL of its own scale, as ``test_torch_train.py``.
One deliberate difference: the port's hybrid decode names the shared
block's sites ``shared{j}/`` (as the forward and the packer do), so a
fused zamba2 artifact decodes here where the reference's decode raises;
it is held against the reference's fused forward, position by position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core.context import CollectCtx as JCollectCtx
from repro.core.context import FpCtx as JFpCtx
from repro.core.context import as_ctx as jas_ctx
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.core.policy import SitePolicy as JSitePolicy
from repro.kernels import dispatch as jdispatch
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.quantize import QuantArtifact as JQuantArtifact
from repro.quantize import quantize_model as jquantize_model
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core.context import FpCtx, as_ctx
from repro_torch.core.muxq import QuantConfig
from repro_torch.core.outliers import CalibrationStats, ChannelStats
from repro_torch.core.policy import SitePolicy
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as S
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.quantize import QuantArtifact, quantize_model

ARCHS = ["mamba2-370m", "zamba2-1.2b", "whisper-tiny"]
FUSED = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
             weight_granularity="per_channel", real_int8=True,
             muxq_form="fused", exp_factor=2, backend="fused")
# fake MUXQ with live outlier detection: no per-site state, so a site's
# name does not change its math
DYNAMIC = dict(method="muxq", outlier_mode="dynamic",
               act_granularity="per_token", weight_granularity="per_channel",
               real_int8=True, muxq_form="fused", exp_factor=2)
HOT = [3, 17, 40]
PROMPT, N_NEW = 12, 6
RTOL = 1e-5
SSD_TOL = 1e-4
DECODE_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_plain_reference():
    """One intra-op thread (bit-equality of the packed buffers needs it;
    see ``test_torch_train.py``) and the reference's fused sites on its
    plain oracle, as its own CPU tests run them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = jdispatch.set_fused_impl("ref")
    try:
        yield
    finally:
        jdispatch.set_fused_impl(prev)
        torch.set_num_threads(n)


def _inputs(cfg, seed=0, b=2, s=PROMPT):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.is_enc_dec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _jextra(batch):
    return ({"frames": jnp.asarray(batch["frames"])} if "frames" in batch
            else None)


def _textra(batch):
    return ({"frames": torch.as_tensor(batch["frames"])} if "frames" in batch
            else None)


def _jforward(jcfg):
    """The reference's calibration forward that carries the frames (its
    default drops them)."""
    return lambda p, b, ctx: JT.forward(jcfg, p, jnp.asarray(b["tokens"]),
                                        ctx, scan=False, extra=_jextra(b))


def _tforward(cfg):
    return lambda p, b, ctx: T.forward(cfg, p, torch.as_tensor(b["tokens"]),
                                       ctx, extra=_textra(b))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def model(request, tmp_path_factory):
    """Reference weights with planted outliers, two calibration batches,
    the reference's calibration stats and its fused MUXQ artifact built
    from them, saved as a bundle."""
    arch = request.param
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params["layers"]["ln1"]["gain"][:, HOT] = 19.0     # RMS/LayerNorm x20
    if jcfg.norm == "layernorm":
        params["layers"]["ln1"]["gain"][:, HOT] = 20.0
    jparams = jax.tree.map(jnp.asarray, params)
    batches = [_inputs(cfg, seed) for seed in (0, 1)]
    jctx = JCollectCtx()
    for batch in batches:
        _jforward(jcfg)(jparams, batch, jctx)
    jart = jquantize_model(jcfg, jparams, jctx.stats,
                           JSitePolicy.uniform(JQuantConfig(**FUSED)))
    path = tmp_path_factory.mktemp("bundle") / "art"
    jart.save(str(path))
    stats = CalibrationStats()
    stats.sites = {k: ChannelStats(v.absmax, v.absmean, v.count)
                   for k, v in jctx.stats.sites.items()}
    return {"arch": arch, "jcfg": jcfg, "cfg": cfg, "params": params,
            "jparams": jparams, "tparams": from_jax_params(cfg, params, "cpu"),
            "batches": batches, "jstats": jctx.stats, "stats": stats,
            "jart": jart, "path": str(path)}


# ---------------------------------------------------------------------------
# configs, trees, convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(arch, reduced):
    import dataclasses
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    names = {f.name for f in dataclasses.fields(cfg)}
    assert names == {f.name for f in dataclasses.fields(jcfg)}
    for name in sorted(names):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for prop in ("family", "head_dim", "padded_vocab", "blocks", "d_inner",
                 "n_ssm_heads", "is_enc_dec"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert A.n_attn_layers(cfg) == JA.n_attn_layers(jcfg)


def test_registry_and_family_precedence_equal_reference():
    assert list_archs() == jlist_archs()
    for arch in list_archs() + ["gpt2-small"]:
        assert get_config(arch).family == jget_config(arch).family, arch
    # an encoder wins over a shared block, which wins over the block kinds
    cfg = get_config("zamba2-1.2b", reduced=True)
    assert cfg.replace(n_enc_layers=2).family == "encdec"
    assert cfg.replace(shared_attn_every=0).family == "ssm"
    assert get_config("zamba2-1.2b").family == "hybrid"
    assert A.n_attn_layers(get_config("zamba2-1.2b")) == 6


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(np.shape(tree))}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Names and shapes of the port's tree (stacked) equal the
    reference's: ``ln1`` + ``ssm`` mamba layers, the hybrid's unstacked
    ``shared`` block, the encoder's ``enc_layers`` and ``enc_ln_f``, the
    decoder's ``cross`` and ``ln3``."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    tp = T.init_params(cfg, seed=0, device="cpu")
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert _shapes(to_reference_layout(tp)) == _shapes(jp)
    assert ("shared" in tp) == (cfg.family == "hybrid")
    assert isinstance(tp.get("enc_layers", []), list)
    ssm = tp["layers"][0].get("ssm")
    if ssm is not None:     # the reference's constants
        assert float(ssm["dt_bias"][0]) == -2.0 and float(ssm["D"][0]) == 1.0


def test_convert_round_trips_every_leaf(model):
    back = to_reference_layout(model["tparams"])
    want = _shapes(model["params"])
    assert _shapes(back) == want
    for path in want:
        a, b = model["params"], back
        for k in path.split("/"):
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b, err_msg=path)
    tp = model["tparams"]
    assert len(tp["layers"]) == model["cfg"].n_layers
    if model["cfg"].is_enc_dec:
        assert len(tp["enc_layers"]) == model["cfg"].n_enc_layers
    if "shared" in tp:
        assert tp["shared"]["attn"]["wqkv"].dim() == 2


# ---------------------------------------------------------------------------
# the SSD and the Mamba2 block
# ---------------------------------------------------------------------------

def _naive_ssd(x, dt, B, C, A_, s0=None):
    """h_t = exp(-dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t (the
    port's copy of ``tests/test_ssm_math.py``'s oracle)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = np.zeros((b, h, n, p), np.float32) if s0 is None else s0
    ys = []
    for t in range(s):
        a = np.exp(-dt[:, t] * A_)
        inject = np.einsum("bn,bh,bhp->bhnp", B[:, t], dt[:, t], x[:, t])
        state = a[..., None, None] * state + inject
        ys.append(np.einsum("bn,bhnp->bhp", C[:, t], state))
    return np.stack(ys, axis=1), state


def _ssd_inputs(b=2, s=21, h=3, p=4, n=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    B = (0.5 * rng.standard_normal((b, s, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, s, n))).astype(np.float32)
    A_ = np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, B, C, A_


@pytest.mark.parametrize("chunk", [1, 3, 8, 21])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    """s 21 is no multiple of 3 or 8 (the tail chunk is padded with dt = 0
    steps); chunk 21 is the whole sequence; the state handed over at step
    10 (``s0``) continues the sequence."""
    cfg = get_config("mamba2-370m", reduced=True).replace(ssm_chunk=chunk)
    jcfg = jget_config("mamba2-370m", reduced=True).replace(ssm_chunk=chunk)
    ins = _ssd_inputs()
    y, s_final = SSM.ssd_chunked(cfg, *map(torch.as_tensor, ins))
    jssd = jax.jit(JSSM.ssd_chunked, static_argnums=0)
    jy, js = jssd(jcfg, *map(jnp.asarray, ins))
    _close(y.numpy(), jy)
    _close(s_final.numpy(), js)
    ny, ns = _naive_ssd(*ins)
    np.testing.assert_allclose(y.numpy(), ny, rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(s_final.numpy(), ns, rtol=SSD_TOL, atol=SSD_TOL)
    cut = 10
    head = [torch.as_tensor(a[:, :cut]) for a in ins[:4]]
    tail = [torch.as_tensor(a[:, cut:]) for a in ins[:4]]
    a_ = torch.as_tensor(ins[4])
    y1, s1 = SSM.ssd_chunked(cfg, *head, a_)
    y2, s2 = SSM.ssd_chunked(cfg, *tail, a_, s0=s1)
    jy2, js2 = jssd(jcfg, *[jnp.asarray(t.numpy()) for t in tail],
                    jnp.asarray(ins[4]), jnp.asarray(s1.numpy()))
    _close(y2.numpy(), jy2)
    _close(s2.numpy(), js2)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), ny,
                               rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(s2.numpy(), ns, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssm_block_and_decode_match_reference():
    """One Mamba2 block (FpCtx) over 11 steps at chunk 8 (one pad step):
    outputs and the decode handoff; then three decode steps from that
    state, each against the reference's ``ssm_decode``."""
    cfg = get_config("mamba2-370m", reduced=True)
    jcfg = jget_config("mamba2-370m", reduced=True)
    jp = jax.tree.map(np.asarray, JSSM.init_ssm(jax.random.PRNGKey(3), jcfg))
    tp = {k: torch.as_tensor(v) for k, v in jp.items()}
    jpj = jax.tree.map(jnp.asarray, jp)
    x = np.random.default_rng(4).standard_normal(
        (2, 14, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, st = SSM.ssm_block(cfg, tp, FpCtx(), torch.as_tensor(x[:, :11]),
                                want_state=True)
    jout, jst = JSSM.ssm_block(jcfg, jpj, JFpCtx(), jnp.asarray(x[:, :11]),
                               conv_state=jnp.zeros(()))
    _close(out.numpy(), jout)
    assert set(st) == set(jst) == {"conv_x", "conv_bc", "ssm"}
    for k in st:
        _close(st[k].numpy(), jst[k])
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    for t in range(11, 14):
        with torch.no_grad():
            o, st = SSM.ssm_decode(cfg, tp, FpCtx(),
                                   torch.as_tensor(x[:, t:t + 1]), st)
        jo, jst = JSSM.ssm_decode(jcfg, jpj, JFpCtx(),
                                  jnp.asarray(x[:, t:t + 1]), jst)
        _close(o.numpy(), jo)
        for k in st:
            _close(st[k].numpy(), jst[k])
        jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    # the O(1) recurrence continues the block: decode == a longer block
    with torch.no_grad():
        full, _ = SSM.ssm_block(cfg, tp, FpCtx(), torch.as_tensor(x))
    _close(o.numpy(), full[:, -1:].numpy(), DECODE_TOL)
    state0 = SSM.init_ssm_state(cfg, 2, 3, device="cpu")
    jstate0 = JSSM.init_ssm_state(jcfg, 2, 3)
    assert {k: tuple(v.shape) for k, v in state0.items()} == {
        k: tuple(v.shape) for k, v in jstate0.items()}


def test_cross_attention_matches_reference():
    cfg = get_config("whisper-tiny", reduced=True)
    jcfg = jget_config("whisper-tiny", reduced=True)
    jp = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(5),
                                                    jcfg, cross=True))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out = A.cross_attention(cfg, {k: torch.as_tensor(v)
                                      for k, v in jp.items()}, FpCtx(),
                                torch.as_tensor(x), torch.as_tensor(mem))
    jout = JA.cross_attention(jcfg, jax.tree.map(jnp.asarray, jp), JFpCtx(),
                              jnp.asarray(x), jnp.asarray(mem))
    _close(out.numpy(), jout)


# ---------------------------------------------------------------------------
# forward, decode, loss
# ---------------------------------------------------------------------------

def test_forward_logits_match_reference(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = _inputs(cfg, seed=7, s=19)     # mamba2 / zamba2: 3 chunks of 8
    with torch.no_grad():
        got = T.forward(cfg, model["tparams"], torch.as_tensor(batch["tokens"]),
                        extra=_textra(batch))["logits"]
    want = jax.jit(lambda p, t, e: JT.forward(jcfg, p, t, extra=e,
                                              scan=False)["logits"])(
        model["jparams"], jnp.asarray(batch["tokens"]), _jextra(batch))
    _close(got.numpy(), want)


def _prefill_decode(model, quant, jquant, params, jparams, n_dec=2):
    """``make_prefill_step`` over PROMPT tokens (an f32 KV cache), then
    ``n_dec`` teacher-forced ``decode_step`` calls, in both packages
    (the reference's steps unscanned): [(port logits, reference logits)]
    of each decode step, and the inputs."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    s_max = PROMPT + n_dec
    batch = _inputs(cfg, seed=8, s=s_max)
    toks = batch["tokens"]
    pb = {"tokens": toks[:, :PROMPT], **({"frames": batch["frames"]}
                                         if "frames" in batch else {})}
    _, cache = S.make_prefill_step(cfg, s_max, quant=quant, device="cpu",
                                   kv_dtype=torch.float32)(
        params, {k: torch.as_tensor(v) for k, v in pb.items()})
    _, jcache = jax.jit(JS.make_prefill_step(
        jcfg, s_max, quant=jquant, scan=False, kv_dtype=jnp.float32))(
        jparams, {k: jnp.asarray(v) for k, v in pb.items()})
    ctx = as_ctx(quant, "cpu")
    jctx, qparams = jas_ctx(jquant)
    jdecode = jax.jit(lambda p, t, c: JT.decode_step(
        jcfg, p, t, c, jctx, qparams=qparams, scan=False))
    pairs = []
    for t in range(PROMPT, s_max):
        with torch.no_grad():
            lg, cache = T.decode_step(cfg, params,
                                      torch.as_tensor(toks[:, t:t + 1]),
                                      cache, ctx)
        jlg, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        pairs.append((lg.numpy(), np.asarray(jlg)))
    assert int(cache["pos"]) == s_max
    return pairs, batch


@pytest.mark.parametrize("kind", ["fp", "fake"])
def test_decode_step_matches_reference(model, kind):
    """Prefill then decode against the reference's steps (jitted,
    unscanned), on FpCtx and on
    fake real-int8 MUXQ with live outlier detection (the reference's
    hybrid decode runs the shared block under bare site names, so only a
    policy without per-site state computes the same there); on fp, the
    decode also equals the port's own forward over the whole sequence."""
    quant = jquant = None
    if kind == "fake":
        quant = SitePolicy.uniform(QuantConfig(**DYNAMIC))
        jquant = JSitePolicy.uniform(JQuantConfig(**DYNAMIC))
    pairs, batch = _prefill_decode(model, quant, jquant, model["tparams"],
                                   model["jparams"])
    for got, want in pairs:
        _close(got, want)
    if kind == "fp":
        with torch.no_grad():
            full = T.forward(model["cfg"], model["tparams"],
                             torch.as_tensor(batch["tokens"]),
                             extra=_textra(batch))["logits"].numpy()
        for j, (got, _) in enumerate(pairs):
            _close(got[:, 0], full[:, PROMPT + j], DECODE_TOL)


def _port_loss_and_grads(cfg, params, batch):
    leaves = [t.detach().requires_grad_(True)
              for t in adamw.tree_leaves(params)]
    p = adamw.tree_unflatten(params, leaves)
    loss, parts = T.lm_loss(cfg, p, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss, parts, adamw.tree_unflatten(params, grads)


def test_lm_loss_grads_and_train_step_match_reference(model):
    """``lm_loss`` (whisper's frames from the batch) and every gradient
    leaf against ``jax.value_and_grad`` (jitted, unscanned), then one
    ``make_train_step`` step: its loss and gradient norm against the
    reference's."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = _inputs(cfg, seed=9, s=10)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda q: JT.lm_loss(jcfg, q, jb, scan=False), has_aux=True))(
            model["jparams"])
    loss, parts, grads = _port_loss_and_grads(cfg, model["tparams"], batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_reference_layout(grads))[0])
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[key] - w).max()) <= GRAD_TOL * scale, key
    jnorm = float(np.sqrt(sum(np.sum(np.square(np.asarray(w, np.float64)))
                              for w in want.values())))
    step = S.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=10),
                             device="cpu")
    new, _, m = step(model["tparams"], adamw.init_state(model["tparams"]),
                     {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=LOSS_RTOL)
    assert _shapes(to_reference_layout(new)) == _shapes(model["params"])


# ---------------------------------------------------------------------------
# the fused MUXQ artifact: buffers, bundles, serving
# ---------------------------------------------------------------------------

def test_fused_buffers_equal_reference(model):
    """The port's ``quantize_model`` on the reference's stats packs the
    same sites (``layer{i}/``, ``enc{i}/``, one ``shared{j}/`` buffer a
    use of the shared block) bit for bit, with the same scan stacks and
    the same {"q", "s"} tree (the shared block and the encoder
    included)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    art = quantize_model(cfg, model["params"], model["stats"],
                         SitePolicy.uniform(QuantConfig(**FUSED)),
                         device="cpu")
    jart = model["jart"]
    assert set(art.kernel_buffers) == set(jart.kernel_buffers)
    bases = {s.split("/")[0].rstrip("0123456789") for s in art.kernel_buffers}
    assert bases == {"mamba2-370m": {"layer"}, "zamba2-1.2b": {"layer", "shared"},
                     "whisper-tiny": {"layer", "enc"}}[model["arch"]]
    n_sites = {"mamba2-370m": 3 * 2, "zamba2-1.2b": 3 * 4 + 4 * 2,
               "whisper-tiny": 7 * 2 + 4 * 2}[model["arch"]]
    assert len(art.kernel_buffers) == n_sites
    for site, buf in jart.kernel_buffers.items():
        for f in dispatch.BUFFER_FIELDS:
            np.testing.assert_array_equal(art.kernel_buffers[site][f],
                                          np.asarray(buf[f]),
                                          err_msg=f"{site} {f}")
    for site, m in jart.masks.items():
        np.testing.assert_array_equal(art.masks[site], m, err_msg=site)
    assert any(m.any() for m in art.masks.values())
    assert set(art.scan_qparams) == set(jart.scan_qparams)
    for key, val in jart.scan_qparams.items():
        for f in (val if isinstance(val, dict) else {None: val}):
            a = art.scan_qparams[key][f] if f else art.scan_qparams[key]
            b = val[f] if f else val
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{key} {f}")
    tq = dict(jax.tree_util.tree_flatten_with_path(
        to_reference_layout(art.params))[0])
    jq = dict(jax.tree_util.tree_flatten_with_path(jart.params)[0])
    assert set(tq) == set(jq)
    for key, val in jq.items():
        np.testing.assert_array_equal(tq[key], np.asarray(val),
                                      err_msg=str(key))


def _port_stream(model, quant, params, batch, n_new=N_NEW):
    cfg = model["cfg"]
    pre = S.make_prefill_step(cfg, PROMPT + n_new, quant=quant, device="cpu",
                              kv_dtype=torch.float32)
    serve = S.make_serve_step(cfg, quant=quant, device="cpu")
    tok, cache = pre(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    out = [tok]
    for _ in range(n_new):
        tok, cache = serve(params, {"tokens": tok[:, None], "cache": cache})
        out.append(tok)
    return torch.stack(out, 1).numpy()


def _jfused_logits(jcfg, jquant, jparams, tokens):
    """The reference's eager forward under ``jquant``'s ctx (site names
    ``layer{i}/``, ``shared{j}/``), jitted."""
    jctx, _ = jas_ctx(jquant)
    fwd = jax.jit(lambda p, t: JT.forward(jcfg, p, t, jctx,
                                          scan=False)["logits"])
    return np.asarray(fwd(jparams, jnp.asarray(tokens)))


def _ref_stream(model, jquant, batch, port_stream, n_new=N_NEW):
    """The reference's eager prefill step, then its serve step (jitted,
    unscanned).  The hybrid's fused decode raises in the reference, so
    there the stream is held to the reference's fused eager forward: one
    forward over the prompt and ``port_stream`` (causal), whose greedy
    token at each position must be the port's next one."""
    jcfg, jparams = model["jcfg"], model["jparams"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tok, cache = jax.jit(JS.make_prefill_step(
        jcfg, PROMPT + n_new, quant=jquant, scan=False,
        kv_dtype=jnp.float32))(jparams, jb)
    out = [np.asarray(tok)]
    if jcfg.family == "hybrid":
        seq = np.concatenate([batch["tokens"], port_stream[:, :-1]], 1)
        lg = _jfused_logits(jcfg, jquant, jparams, seq)[:, PROMPT:,
                                                        :jcfg.vocab_size]
        return np.concatenate([out[0][:, None], np.asarray(
            jnp.argmax(lg, -1))], 1)
    serve = jax.jit(JS.make_serve_step(jcfg, quant=jquant, scan=False))
    for _ in range(n_new):
        tok, cache = serve(jparams, {"tokens": tok[:, None], "cache": cache})
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def test_reference_bundle_serves_in_the_port(model):
    """The reference-written fused bundle, loaded by the port: the prefill
    and N_NEW serve steps give the reference's stream (zamba2: its fused
    forward's greedy tokens)."""
    batch = _inputs(model["cfg"], seed=10)
    art = QuantArtifact.load(model["path"])
    got = _port_stream(model, art, model["tparams"], batch)
    assert (got == _ref_stream(model, model["jart"], batch, got)).all()


def test_port_bundle_serves_in_the_reference(model, tmp_path):
    """The port calibrates through its own forward (whisper's carrying the
    frames) and writes the bundle (pack target ``fused``: the stacks'
    leaves stubbed, the shared block's kept); the reference loads it, and
    its eager stream equals the port's on the same bundle."""
    cfg = model["cfg"]
    art = quantize_model(cfg, model["params"], model["batches"],
                         SitePolicy.uniform(QuantConfig(**FUSED)),
                         forward=_tforward(cfg), pack_target="fused",
                         device="cpu")
    for site, m in model["jart"].masks.items():
        np.testing.assert_array_equal(art.masks[site], m, err_msg=site)
    art.save(tmp_path / "art")
    jart = JQuantArtifact.load(str(tmp_path / "art"))
    assert set(jart.kernel_buffers) == set(model["jart"].kernel_buffers)
    stub = jart.params["layers"]["ssm" if cfg.family != "encdec" else "attn"]
    assert np.asarray(stub["in_zx" if cfg.family != "encdec" else "wqkv"]
                      ["q"]).shape[1:] == (1, 1)
    if cfg.family == "hybrid":
        assert np.asarray(jart.params["shared"]["attn"]["wqkv"]["q"]).shape \
            == tuple(model["params"]["shared"]["attn"]["wqkv"].shape)
    batch = _inputs(cfg, seed=11)
    got = _port_stream(model, QuantArtifact.load(tmp_path / "art"),
                       model["tparams"], batch)
    assert (got == _ref_stream(model, jart, batch, got)).all()


@pytest.mark.parametrize("model", ["zamba2-1.2b"], indirect=True)
def test_hybrid_fused_decode_follows_the_reference_forward(model):
    """The kept difference: the reference's hybrid decode raises on a
    fused artifact (the shared block runs unnamed, without its buffers),
    while the port's, naming it ``shared{j}/`` as the forward does,
    decodes: each decode step's logits equal the reference's fused eager
    forward's at that position (RTOL of their scale)."""
    jcfg, jart = model["jcfg"], model["jart"]
    cfg = model["cfg"]
    jcache = {**JSSM.init_ssm_state(jcfg, 2, jcfg.n_layers),
              **JA.init_cache(jcfg, 2, 4, dtype=jnp.float32)}
    jctx, qparams = jas_ctx(jart)
    with pytest.raises(RuntimeError, match="needs packed kernel buffers"):
        jax.jit(lambda p, c: JT.decode_step(     # raises while it traces
            jcfg, p, jnp.zeros((2, 1), jnp.int32), c, jctx, qparams=qparams,
            scan=False))(model["jparams"], jcache)
    art = QuantArtifact.load(model["path"])
    batch = _inputs(cfg, seed=8, s=PROMPT + 3)
    toks = batch["tokens"]
    _, cache = S.make_prefill_step(cfg, PROMPT + 3, quant=art, device="cpu",
                                   kv_dtype=torch.float32)(
        model["tparams"], {"tokens": torch.as_tensor(toks[:, :PROMPT])})
    ctx = as_ctx(art, "cpu")
    want = _jfused_logits(jcfg, jart, model["jparams"], toks)
    for t in range(PROMPT, PROMPT + 3):
        with torch.no_grad():
            lg, cache = T.decode_step(cfg, model["tparams"],
                                      torch.as_tensor(toks[:, t:t + 1]),
                                      cache, ctx)
        _close(lg[:, 0].numpy(), want[:, t])
    assert {ctx.backend_log[f"shared{j}/attn_qkv"] for j in range(2)} == {
        "fused"}


# ---------------------------------------------------------------------------
# what the reference refuses, the port refuses
# ---------------------------------------------------------------------------

def test_whisper_default_calibration_forward_drops_the_frames():
    """As the reference's: the default calibration forward passes only the
    tokens, so an encoder-decoder fails there (TypeError); a ``forward=``
    that carries the frames packs every encoder and decoder site."""
    cfg, jcfg = (get_config("whisper-tiny", reduced=True),
                 jget_config("whisper-tiny", reduced=True))
    params = T.init_params(cfg, seed=1, device="cpu")
    batches = [_inputs(cfg, seed=12)]
    policy = SitePolicy.uniform(QuantConfig(**FUSED))
    with pytest.raises(TypeError):
        quantize_model(cfg, params, batches, policy, device="cpu")
    jparams = jax.tree.map(jnp.asarray, to_reference_layout(params))
    with pytest.raises(TypeError):
        jquantize_model(jcfg, jparams, batches,
                        JSitePolicy.uniform(JQuantConfig(**FUSED)))
    art = quantize_model(cfg, params, batches, policy, forward=_tforward(cfg),
                         device="cpu")
    assert len(art.kernel_buffers) == 22


def test_hybrid_shared_weight_smooth_pack_raises():
    """As ``tests/test_policy_artifact.py``: the shared block's one weight
    cannot fold a per-instance smoothing factor, so packing refuses;
    planning alone keeps the ``shared{j}/`` factors."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    batches = [{"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 8))}]
    pol = SitePolicy.uniform(QuantConfig(method="smoothquant",
                                         act_granularity="per_token"))
    with pytest.raises(ValueError, match="shared/multi-instance"):
        quantize_model(cfg, params, batches, pol, device="cpu")
    art = quantize_model(cfg, params, batches, pol, prequantize=False,
                         device="cpu")
    assert any(s.startswith("shared") for s in art.smooth_factors)


def test_paged_steps_refuse_the_new_families():
    """``ServeEngine`` and the paged steps stay dense/MoE-only, as the
    reference's."""
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        params = T.init_params(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="dense and MoE"):
            T.decode_step_paged(cfg, params,
                                torch.zeros(1, 1, dtype=torch.long), {},
                                None, None)
