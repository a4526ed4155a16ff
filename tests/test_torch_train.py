"""Training in the port (``optim/adamw.py``, ``transformer.lm_loss`` under
autograd, ``launch/steps.py``, ``train/trainer.py``, ``checkpoint/ckpt.py``,
``models/surgery.py``, ``launch/train.py``) against the JAX reference on
the CPU.

Both packages get the same weights (the reference's ``init_params`` tree,
passed to the port through ``convert.from_jax_params``) and the same
seeded numpy batches.  Tolerances:
  * AdamW: params, ``mu`` and ``nu`` within OPT_RTOL of each leaf's scale
    after 5 steps; ``schedule_lr`` equal at step 0, at the end of warmup
    and at the last step (within OPT_RTOL elsewhere: f32 ``cos``);
  * ``lm_loss`` within LOSS_RTOL relative, each gradient leaf within
    GRAD_TOL of its own scale (max |ref|);
  * the 20-step loss curve within CURVE_RTOL relative: measured 1.6e-7
    (gpt2) and 3.4e-7 (llama4-scout): XLA and PyTorch sum the matmuls,
    ``logsumexp`` and softmax in other orders, and AdamW's normalized
    update carries the ulps forward;
  * checkpoints, the port's resume, outlier surgery and the pipeline:
    bit-equal;
  * dense-cache decode logits within DECODE_TOL of their scale; the fused
    evaluation's CE within EVAL_RTOL relative.
The port runs on CPU tensors, i.e. through the kernels' plain versions.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.core.context import FpCtx as JFpCtx
from repro.core.policy import SitePolicy as JSitePolicy
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as JS
from repro.models import moe as JE
from repro.models import surgery as JSurgery
from repro.models import transformer as JT
from repro.models.attention import init_cache as jinit_cache
from repro.optim import adamw as JA
from repro.quantize import quantize_model as jquantize_model
from repro.serve import kvcache as jkvcache
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import (as_port_opt_state, from_jax_params,
                                 opt_state_to_reference_layout,
                                 to_reference_layout)
from repro_torch.core.context import FpCtx, as_ctx
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.data.synthetic import corpus
from repro_torch.launch import steps as S
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as E
from repro_torch.models import surgery
from repro_torch.models import transformer as T
from repro_torch.models.attention import init_cache
from repro_torch.optim import adamw as A
from repro_torch.quantize import QuantArtifact
from repro_torch.serve import kvcache
from repro_torch.train.trainer import TrainConfig, Trainer

OPT_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
CURVE_RTOL = 1e-6
DECODE_TOL = 1e-5
EVAL_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8      # cast_bf16: one bf16 rounding of the weights

# internvl2-2b: the loss over the text positions after the patch prefix
LOSS_ARCHS = ["gpt2-small", "qwen2-0.5b", "gemma2-9b", "llama4-scout-17b-a16e",
              "internvl2-2b"]
TRAIN_ACFG = dict(lr=3e-3, total_steps=20, warmup_steps=4)
TRAIN_PCFG = dict(seq_len=32, global_batch=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the port's computations here are small, the
    test workers share the machine's cores, and the bit-equality claims
    need it (with several threads the CPU's BLAS may split a product
    differently between two calls when the machine is busy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _configs(arch):
    return jget_config(arch, reduced=True), get_config(arch, reduced=True)


def _ref_params(jcfg, seed=0):
    return jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(seed)))


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves_with_keys(tree):
    """(key, numpy leaf) pairs of a reference-layout tree, jax's order."""
    return [("/".join(str(getattr(p, "key", p)) for p in path), np.asarray(l))
            for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_trees_close(port_ref_layout, ref, rtol, label=""):
    got = dict(_leaves_with_keys(port_ref_layout))
    for key, want in _leaves_with_keys(ref):
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got[key].astype(np.float64) - want).max())
        assert err <= rtol * scale, (label, key, err, scale)


def _assert_trees_equal(a, b):
    la, lb = _leaves_with_keys(a), _leaves_with_keys(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y), k


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_adamw_matches_reference(schedule):
    """5 steps with clipping (every step clips) and weight decay: params,
    moments, lr and grad norm against the reference's; the inputs are not
    modified."""
    jcfg, cfg = _configs("gpt2-small")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, schedule=schedule,
              weight_decay=0.1, clip_norm=0.5)
    jacfg, acfg = JA.AdamWConfig(**kw), A.AdamWConfig(**kw)
    jp = _ref_params(jcfg)
    p = from_jax_params(cfg, jp, "cpu")
    jstate = JA.init_state(jax.tree.map(jnp.asarray, jp))
    state = A.init_state(p)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(jnp.asarray, jp)
    for _ in range(5):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), jax.tree.map(np.asarray, jp))
        g = from_jax_params(cfg, g_np, "cpu")
        jp, jstate, jm = JA.apply_updates(jacfg, jp, jax.tree.map(
            jnp.asarray, g_np), jstate)
        p, state, m = A.apply_updates(acfg, p, g, state)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=OPT_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)
        assert float(jm["grad_norm"]) > kw["clip_norm"]
    assert int(state["step"]) == int(jstate["step"]) == 5
    assert state["step"].dtype == torch.int32
    _assert_trees_close(to_reference_layout(p), jp, OPT_RTOL, "params")
    for mom in ("mu", "nu"):
        _assert_trees_close(to_reference_layout(state[mom]), jstate[mom],
                            OPT_RTOL, mom)


def test_adamw_leaves_its_inputs_untouched():
    _, cfg = _configs("gpt2-small")
    p = T.init_params(cfg, seed=1, device="cpu")
    g = A.tree_map(torch.ones_like, p)
    state = A.init_state(p)
    keep = copy.deepcopy((p, g, state))
    new_p, new_state, _ = A.apply_updates(A.AdamWConfig(), p, g, state)
    for x, y in zip(A.tree_leaves(keep), A.tree_leaves((p, g, state))):
        assert torch.equal(x, y)
    assert not torch.equal(new_p["embed"], p["embed"])
    assert int(new_state["step"]) == 1 and int(state["step"]) == 0


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=50, schedule=schedule)
    jacfg, acfg = JA.AdamWConfig(**kw), A.AdamWConfig(**kw)
    for step in range(0, 56):
        got = float(A.schedule_lr(acfg, torch.tensor(step, dtype=torch.int32)))
        want = float(JA.schedule_lr(jacfg, jnp.asarray(step, jnp.int32)))
        if step in (0, 10, 50):
            assert got == want, (step, got, want)
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, err_msg=str(step))


# ---------------------------------------------------------------------------
# lm_loss and its gradients; MoE capacity; remat
# ---------------------------------------------------------------------------

def _port_loss_and_grads(cfg, params, batch, **kw):
    leaves = [t.detach().requires_grad_(True) for t in A.tree_leaves(params)]
    p = A.tree_unflatten(params, leaves)
    loss, parts = T.lm_loss(cfg, p, _tb(batch), **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, parts, A.tree_unflatten(params, grads)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """The loss (train=True: llama4's capacity dispatch drops tokens at
    s 24) and every gradient leaf against ``jax.value_and_grad``."""
    jcfg, cfg = _configs(arch)
    jp = _ref_params(jcfg)
    batch = _batch(cfg, 2, 24)
    if cfg.n_patches:
        batch["patches"] = np.random.default_rng(1).standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda q: JT.lm_loss(jcfg, q, _jb(batch)), has_aux=True)(
            jax.tree.map(jnp.asarray, jp))
    loss, parts, grads = _port_loss_and_grads(
        cfg, from_jax_params(cfg, jp, "cpu"), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=LOSS_RTOL)
    if cfg.family == "moe":
        assert float(parts["aux"]) > 0
    _assert_trees_close(to_reference_layout(grads), jgrads, GRAD_TOL, arch)
    # the padded vocabulary rows get exactly no gradient
    assert torch.count_nonzero(grads["embed"][cfg.vocab_size:]) == 0


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "dbrx-132b"])
def test_moe_capacity_dispatch_matches_reference(arch):
    """train=True: the reference's capacity, the same dropped assignments,
    slots and tokens on the same probabilities, and the same block output
    and aux loss."""
    jcfg, cfg = _configs(arch)
    jp = jax.tree.map(np.array, JE.init_moe(jax.random.PRNGKey(4), jcfg))
    p = {k: (torch.as_tensor(v) if not isinstance(v, dict)
             else {kk: torch.as_tensor(vv) for kk, vv in v.items()})
         for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model)
                                                 ).astype(np.float32)
    for t in (24, 100):
        assert E._capacity(cfg, t, 1.25) == JE._capacity(jcfg, t, 1.25)
    cap = E._capacity(cfg, 24, 1.25)
    probs = torch.softmax(torch.as_tensor(x) @ p["router"], -1)
    _, slot, st, _, keep = E._dispatch_group(cfg, torch.as_tensor(x), probs,
                                             cap)
    _, jslot, jst, _, jkeep = jax.vmap(
        lambda xf, pr: JE._dispatch_group(jcfg, xf, pr, cap))(
            jnp.asarray(x), jnp.asarray(probs.numpy()))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert not keep.all(), "the capacity factor must drop assignments here"
    out, aux = E.moe(cfg, p, FpCtx(), torch.as_tensor(x), train=True)
    jout, jaux = JE.moe(jcfg, jax.tree.map(jnp.asarray, jp), JFpCtx(),
                        jnp.asarray(x), train=True)
    scale = float(np.abs(np.asarray(jout)).max())
    assert float((out - torch.as_tensor(np.asarray(jout))).abs().max()) \
        <= LOSS_RTOL * scale
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)
    dropless, _ = E.moe(cfg, p, FpCtx(), torch.as_tensor(x))
    assert not torch.equal(dropless, out)


@pytest.mark.parametrize("arch", ["gemma2-9b", "llama4-scout-17b-a16e"])
def test_remat_gradients_equal(arch):
    _, cfg = _configs(arch)
    params = T.init_params(cfg, seed=2, device="cpu")
    batch = _batch(cfg, 2, 16, seed=1)
    l0, _, g0 = _port_loss_and_grads(cfg, params, batch)
    l1, _, g1 = _port_loss_and_grads(cfg.replace(remat=True), params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(A.tree_leaves(g0), A.tree_leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cast_bf16", [False, True])
def test_train_step_matches_reference(cast_bf16):
    """One step's metrics against the reference's (the bf16 forward within
    one bf16 rounding); the step is ``lm_loss``'s autograd gradients
    through ``apply_updates``, bit for bit.  The new params are not held
    to the reference's: AdamW's first update is g / (|g| + eps), which
    turns gradients at the noise level of the two frameworks' summation
    orders into updates of up to lr (the gradients and ``apply_updates``
    are each held above)."""
    jcfg, cfg = _configs("gpt2-small")
    jp = _ref_params(jcfg)
    batch = _batch(cfg, 2, 16, seed=2)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**kw),
                                       cast_bf16=cast_bf16))
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, jstate, jm = jstep(jparams, JA.init_state(jparams), _jb(batch))
    step = S.make_train_step(cfg, A.AdamWConfig(**kw), cast_bf16=cast_bf16,
                             device="cpu")
    p = from_jax_params(cfg, jp, "cpu")
    new, state, m = step(p, A.init_state(p), _tb(batch))
    assert set(m) == set(jm) == {"loss", "ce", "aux", "lr", "grad_norm"}
    rtol = BF16_RTOL if cast_bf16 else LOSS_RTOL
    for key in ("loss", "ce", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol,
                                   err_msg=key)
    assert all(not t.requires_grad for t in A.tree_leaves(new))
    if not cast_bf16:
        _, _, grads = _port_loss_and_grads(cfg, p, batch)
        want, want_state, _ = A.apply_updates(A.AdamWConfig(**kw), p, grads,
                                              A.init_state(p))
        for a, b in zip(A.tree_leaves((new, state)),
                        A.tree_leaves((want, want_state))):
            assert torch.equal(a, b)
    if cast_bf16:       # the bf16 forward is not the f32 one
        f32 = S.make_train_step(cfg, A.AdamWConfig(**kw), device="cpu")
        assert float(f32(p, A.init_state(p), _tb(batch))[2]["loss"]) \
            != float(m["loss"])


@pytest.fixture(scope="module")
def fused_bundle(tmp_path_factory):
    """A reference-written fused MUXQ bundle of the reduced gpt2 (with a
    few norm-gain channels x20, so calibration finds outliers) and its
    raw weights."""
    jcfg, cfg = _configs("gpt2-small")
    jp = _ref_params(jcfg)
    for ln in ("ln1", "ln2"):
        jp["layers"][ln]["gain"][:, [3, 17, 40]] *= 20.0
    calib = [{"tokens": _batch(cfg, 2, 16, seed=s)["tokens"]} for s in (7, 8)]
    art = jquantize_model(jcfg, jax.tree.map(jnp.asarray, jp), calib,
                          JSitePolicy.uniform(JS.MUXQ_FUSED_SERVE))
    path = str(tmp_path_factory.mktemp("fused") / "art")
    art.save(path)
    return jcfg, cfg, jp, art, path


def test_fused_eval_step_matches_reference(fused_bundle):
    """make_eval_step on the reference's fused bundle: every site on the
    fused backend (the kernels' plain versions), CE within EVAL_RTOL."""
    jcfg, cfg, jp, jart, path = fused_bundle
    art = QuantArtifact.load(path)
    step = S.make_eval_step(cfg, quant=art, device="cpu")
    jstep = jax.jit(JS.make_eval_step(jcfg, quant=jart))
    p = from_jax_params(cfg, jp, "cpu")
    for seed in (11, 12):
        batch = _batch(cfg, 2, 16, seed=seed)
        ce = float(step(p, _tb(batch)))
        jce = float(jstep(jax.tree.map(jnp.asarray, jp), _jb(batch)))
        np.testing.assert_allclose(ce, jce, rtol=EVAL_RTOL)
    ctx = as_ctx(art, "cpu")
    with torch.no_grad():
        T.lm_loss(cfg, p, _tb(_batch(cfg, 2, 16)), ctx)
    assert set(ctx.backend_log.values()) == {"fused"}
    assert len(ctx.backend_log) == 4 * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-9b"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_decode_after_prefill_matches_reference(arch, mode):
    """forward(cache=...) then 4 decode steps (gemma2's window of 8 is
    crossed).  int8: the reference quantizes its fp prefill cache with
    ``quantize_kv`` and decodes on it; the port prefills straight into
    ``init_int8_cache``, which must hold the same codes (on these inputs
    no K or V value sits an ulp from a rounding boundary)."""
    jcfg, cfg = _configs(arch)
    jp = _ref_params(jcfg)
    p = from_jax_params(cfg, jp, "cpu")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, jp)
    jout = JT.forward(jcfg, jparams, jnp.asarray(prompt),
                      cache=jinit_cache(jcfg, 2, 16, dtype=jnp.float32))
    jc = jout["cache"]
    if mode == "int8":
        qc = jkvcache.quantize_kv(jc["k"], jc["v"])
        jc = {**qc, "pos": jc["pos"]}
        cache = kvcache.init_int8_cache(cfg, 2, 16, device="cpu")
    else:
        cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        out = T.forward(cfg, p, torch.as_tensor(prompt), cache=cache)
    c = out["cache"]
    assert int(c["pos"]) == int(jc["pos"]) == 12
    for n in jc:             # the written positions (the reference's
        if n != "pos":       # quantize_kv also rescales the empty ones)
            got, want = c[n][:, :, :12].numpy(), np.asarray(jc[n])[:, :, :12]
            if got.dtype == np.int8:       # the codes: equal
                np.testing.assert_array_equal(got, want, err_msg=n)
            else:                          # K/V and scales: ulps apart
                np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL
                                           * float(np.abs(want).max()))
    for j in range(4):
        tok = nxt[:, j:j + 1]
        jlog, jc = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        with torch.no_grad():
            log, c = T.decode_step(cfg, p, torch.as_tensor(tok), c)
        want = np.asarray(jlog)
        err = float(np.abs(log.numpy() - want).max())
        assert err <= DECODE_TOL * float(np.abs(want).max()), (j, err)
    assert int(c["pos"]) == 16


def test_prefill_and_serve_steps():
    """make_prefill_step + make_serve_step: the first token is the argmax
    of the prefill's last logits, each serve step's the decode's, and the
    teacher-forced decode logits equal a full forward's last row."""
    _, cfg = _configs("qwen2-0.5b")
    p = T.init_params(cfg, seed=3, device="cpu")
    toks = torch.as_tensor(_batch(cfg, 2, 8, seed=9)["tokens"])
    prefill = S.make_prefill_step(cfg, 12, kv_dtype=torch.float32,
                                  device="cpu")
    serve = S.make_serve_step(cfg, device="cpu")
    first, cache = prefill(p, {"tokens": toks})
    assert first.dtype == torch.int32 and cache["k"].shape[2] == 12
    seq = torch.cat([toks, first[:, None]], 1)
    nxt, cache = serve(p, {"tokens": first[:, None], "cache": cache})
    with torch.no_grad():
        full = T.forward(cfg, p, seq)["logits"][:, -1, : cfg.vocab_size]
    assert torch.equal(nxt, torch.argmax(full, -1).to(torch.int32))
    first8, cache8 = S.make_prefill_step(cfg, 12, kv_dtype=torch.int8,
                                         device="cpu")(p, {"tokens": toks})
    assert cache8["k"].dtype == torch.int8 and "k_scale" in cache8
    assert kvcache.cache_bytes(cache8) < kvcache.cache_bytes(cache)
    # the step builders take the SSM, hybrid and enc-dec families too (held
    # against the reference in test_torch_families.py): one train step each
    for arch in ("mamba2-370m", "zamba2-1.2b", "whisper-tiny"):
        c = get_config(arch, reduced=True)
        p = T.init_params(c, seed=3, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in _batch(c, 2, 8).items()}
        if c.is_enc_dec:
            batch["frames"] = torch.randn(2, c.n_audio_frames, c.d_model)
        new, state, m = S.make_train_step(c, device="cpu")(
            p, A.init_state(p), batch)
        assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1


def test_int8_cache_contract_and_bytes():
    jcfg, cfg = _configs("qwen2-0.5b")
    c = kvcache.init_int8_cache(cfg, 2, 16, device="cpu")
    jc = jkvcache.init_int8_cache(jcfg, 2, 16)
    assert set(c) == set(jc)
    for n in c:
        assert tuple(c[n].shape) == tuple(jc[n].shape), n
        assert str(c[n].dtype).split(".")[-1] == str(jc[n].dtype), n
    assert kvcache.cache_bytes(c) == jkvcache.cache_bytes(jc)
    fp = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    assert kvcache.cache_bytes(fp) == jkvcache.cache_bytes(
        jinit_cache(jcfg, 2, 16, dtype=jnp.float32))
    q = kvcache.quantize_kv(torch.randn(2, 3, 1, 8), torch.zeros(2, 3, 1, 8))
    k, v = kvcache.dequantize_kv(q, torch.float32)
    jk, jv = jkvcache.dequantize_kv({n: jnp.asarray(t.numpy())
                                     for n, t in q.items()}, jnp.float32)
    assert np.array_equal(k.numpy(), np.asarray(jk))
    assert torch.count_nonzero(v) == 0


# ---------------------------------------------------------------------------
# Trainer, resume, checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs():
    """The reference's 20-step runs of gpt2 and llama4 (log every step)
    and their initial params and optimizer state."""
    out = {}
    for arch in ("gpt2-small", "llama4-scout-17b-a16e"):
        jcfg = jget_config(arch, reduced=True)
        jt = JTrainer(jcfg, JTrainConfig(steps=20, log_every=1),
                      JPipelineConfig(**TRAIN_PCFG),
                      JA.AdamWConfig(**TRAIN_ACFG))
        p0 = jax.tree.map(np.array, jt.params)
        o0 = jax.tree.map(np.array, jt.opt_state)
        out[arch] = (p0, o0, jt.run())
    return out


def _port_trainer(cfg, steps=20, **tkw):
    return Trainer(cfg, TrainConfig(steps=steps, log_every=1, **tkw),
                   PipelineConfig(**TRAIN_PCFG), A.AdamWConfig(**TRAIN_ACFG),
                   device="cpu")


@pytest.mark.parametrize("arch", ["gpt2-small", "llama4-scout-17b-a16e"])
def test_trainer_loss_curve_matches_reference(ref_runs, arch):
    p0, o0, jout = ref_runs[arch]
    cfg = get_config(arch, reduced=True)
    tr = _port_trainer(cfg)
    tr.params = from_jax_params(cfg, p0, "cpu")
    tr.opt_state = as_port_opt_state(cfg, o0, "cpu")
    out = tr.run()
    assert out["steps"] == 20 and len(out["history"]) == 20
    got = np.array([h["loss"] for h in out["history"]])
    want = np.array([h["loss"] for h in jout["history"]])
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    assert got[-1] < got[0]


def test_crash_and_resume_is_bit_equal(tmp_path):
    """A run that dies at step 5 (checkpoints every 3) and is started again
    ends with the uninterrupted run's params, state and losses."""
    _, cfg = _configs("gpt2-small")
    straight = _port_trainer(cfg, steps=10)
    ref = straight.run()

    class Crash(Exception):
        pass

    def die(step, _):
        if step == 5:
            raise Crash

    d = str(tmp_path / "ck")
    with pytest.raises(Crash):
        _port_trainer(cfg, steps=10, ckpt_dir=d, ckpt_every=3).run(die)
    assert ckpt.latest_step(d) == 3
    again = _port_trainer(cfg, steps=10, ckpt_dir=d, ckpt_every=3)
    assert again.step == 3 and again.pipe.step == 3
    out = again.run()
    assert out["history"] == ref["history"][3:]
    for a, b in zip(A.tree_leaves((straight.params, straight.opt_state)),
                    A.tree_leaves((again.params, again.opt_state))):
        assert torch.equal(a, b)
    assert ckpt.latest_step(d) == 10


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, cfg = _configs("llama4-scout-17b-a16e")
    tr = _port_trainer(cfg, steps=2)
    tr.run()
    d = tmp_path / "ck"
    ckpt.save(d, 2, tr.params, tr.opt_state, extra={"data": {"step": 2}})
    jtemplate = JT.init_params(jcfg, jax.random.PRNGKey(1))
    params, opt, meta = jckpt.restore(str(d), 2, jtemplate,
                                      JA.init_state(jtemplate))
    assert meta == {"step": 2, "data": {"step": 2}}
    _assert_trees_equal(jax.tree.map(np.asarray, params),
                        to_reference_layout(tr.params))
    _assert_trees_equal(jax.tree.map(np.asarray, opt),
                        opt_state_to_reference_layout(tr.opt_state))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, cfg = _configs("gemma2-9b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    jo = JA.init_state(jp)
    jo = {"mu": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
              a.shape).astype(np.float32)), jo["mu"]),
          "nu": jax.tree.map(lambda a: jnp.asarray(rng.random(
              a.shape).astype(np.float32)), jo["nu"]),
          "step": jnp.asarray(7, jnp.int32)}
    jckpt.save(str(tmp_path), 7, jp, jo, extra={"data": {"step": 7}})
    template = T.init_params(cfg, seed=5, device="cpu")
    params, opt, meta = ckpt.restore(tmp_path, 7, template,
                                     A.init_state(template))
    assert meta["step"] == 7 and isinstance(params["layers"], list)
    _assert_trees_equal(to_reference_layout(params),
                        jax.tree.map(np.asarray, jp))
    _assert_trees_equal(opt_state_to_reference_layout(opt),
                        jax.tree.map(np.asarray, jo))
    assert opt["step"].dtype == torch.int32


def test_reference_trainer_checkpoint_is_finished_by_the_port(ref_runs,
                                                              tmp_path):
    """The reference trains gpt2 to step 10 and checkpoints; the port
    resumes (params, state, pipeline position) and trains to 20: its
    final loss is the reference's uninterrupted run's."""
    jcfg, cfg = _configs("gpt2-small")
    d = str(tmp_path / "ck")
    JTrainer(jcfg, JTrainConfig(steps=10, log_every=5, ckpt_dir=d,
                                ckpt_every=10),
             JPipelineConfig(**TRAIN_PCFG),
             JA.AdamWConfig(**TRAIN_ACFG)).run()
    tr = _port_trainer(cfg, ckpt_dir=d, ckpt_every=10)
    assert tr.step == 10 and tr.pipe.step == 10
    out = tr.run()
    want = ref_runs["gpt2-small"][2]["history"]
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in want[10:]],
                               rtol=CURVE_RTOL)
    assert jckpt.latest_step(d) == 20


def test_checkpoint_gc_latest_and_errors(tmp_path):
    jcfg, cfg = _configs("gpt2-small")
    p = T.init_params(cfg, seed=0, device="cpu")
    for step in range(1, 6):
        ckpt.save(tmp_path, step, p, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000004",
                                            "step_00000005"]
    assert ckpt.latest_step(tmp_path) == jckpt.latest_step(str(tmp_path)) == 5
    (tmp_path / "LATEST").write_text("9")          # LATEST lies
    assert ckpt.latest_step(tmp_path) == jckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(tmp_path / "none") is None
    assert not list(tmp_path.glob(".tmp_*"))
    # the same errors as the reference's on a mismatched template
    small = cfg.replace(d_model=32, n_heads=2, n_kv_heads=2)
    jsmall = jcfg.replace(d_model=32, n_heads=2, n_kv_heads=2)
    with pytest.raises(ValueError) as e:
        ckpt.restore(tmp_path, 5, T.init_params(small, device="cpu"))
    with pytest.raises(ValueError) as je:
        jckpt.restore(str(tmp_path), 5, JT.init_params(
            jsmall, jax.random.PRNGKey(0)))
    assert str(e.value) == str(je.value)
    no_lnf = {k: v for k, v in p.items() if k != "ln_f"}
    ckpt.save(tmp_path / "b", 1, no_lnf)
    with pytest.raises(KeyError) as e:
        ckpt.restore(tmp_path / "b", 1, p)
    with pytest.raises(KeyError) as je:
        jckpt.restore(str(tmp_path / "b"), 1, JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
    assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# Pipeline, surgery, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_pipeline_host_split_and_state(n_hosts):
    for seed in (0, 3):
        text = corpus(500, seed=seed)
        for host in range(n_hosts):
            kw = dict(seq_len=16, global_batch=8, seed=seed, n_hosts=n_hosts,
                      host_id=host)
            pipe = TokenPipeline(PipelineConfig(**kw), text=text)
            jpipe = JTokenPipeline(JPipelineConfig(**kw), text=text)
            assert pipe.host_batch == jpipe.host_batch == 8 // n_hosts
            for step in (0, 1, 5):
                b, jb = pipe.batch_at(step), jpipe.batch_at(step)
                for k in ("tokens", "labels"):
                    assert np.array_equal(b[k], jb[k]), (seed, host, step, k)
            next(pipe), next(pipe)
            assert pipe.state_dict() == {"step": 2}
            other = TokenPipeline(PipelineConfig(**kw), text=text)
            other.load_state_dict(pipe.state_dict())
            assert np.array_equal(next(other)["tokens"],
                                  jpipe.batch_at(2)["tokens"])
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(PipelineConfig(global_batch=6, n_hosts=4), text=text)


@pytest.mark.parametrize("arch", ["gpt2-small", "qwen2-0.5b"])
def test_inject_outliers_matches_reference(arch):
    """LayerNorm (gpt2) and RMSNorm's offset gain (qwen2): bit-equal to
    the reference's surgery; the input is left untouched."""
    jcfg, cfg = _configs(arch)
    jp = _ref_params(jcfg, seed=3)
    ch = surgery.pick_outlier_channels(cfg, 5, seed=1)
    assert np.array_equal(ch, JSurgery.pick_outlier_channels(jcfg, 5, seed=1))
    p = from_jax_params(cfg, jp, "cpu")
    keep = copy.deepcopy(p)
    out = surgery.inject_outliers(cfg, p, ch, 20.0)
    jout = JSurgery.inject_outliers(jcfg, jax.tree.map(jnp.asarray, jp), ch,
                                    20.0)
    _assert_trees_equal(to_reference_layout(out),
                        jax.tree.map(np.asarray, jout))
    for a, b in zip(A.tree_leaves(keep), A.tree_leaves(p)):
        assert torch.equal(a, b)
    moe_cfg = get_config("llama4-scout-17b-a16e", reduced=True)
    with pytest.raises(ValueError, match="dense"):
        surgery.inject_outliers(moe_cfg, p, ch)


def test_launch_train_prints_resumes_and_refuses(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = ["--device", "cpu", "--seq-len", "16", "--batch", "2",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "step     4 loss" in out and "done: 4 steps, final loss" in out
    assert ckpt.latest_step(d) == 4
    assert launch_train.main(args + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "done: 6 steps" in out and "step     6 loss" in out
    assert launch_train.main(args + ["--steps", "6", "--no-resume"]) == 0
    assert "done: 6 steps" in capsys.readouterr().out
    assert launch_train.main(["--device", "cpu", "--arch", "nope"]) == 2
    assert "unknown arch" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert launch_train.main(["--steps", "1"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
