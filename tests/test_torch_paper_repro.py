"""The paper's Table-1 claims on a model the port trained: the reference's
``tests/test_paper_repro.py`` held by the port.

The port's ``Trainer`` trains the reference test's tiny GPT-2 config for
120 steps on the CPU; the port's ``inject_outliers`` plants channel
outliers (function-preserving); the port's ``calibrate`` finds them; the
port's ``forward`` with a ``QuantCtx`` evaluates perplexity per method.
Then the reference evaluates the same weights (the port's trained params
in its stacked layout, calibrated by its own ``calibrate``): the masks are
equal and every method's perplexity is within PPL_RTOL relative, so one
training run serves both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.calibrate import calibrate as jcalibrate
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.muxq import QuantConfig as JQuantConfig
from repro.models import transformer as JT
from repro.models.common import cross_entropy as jcross_entropy
from repro_torch.configs import get_config
from repro_torch.convert import to_reference_layout
from repro_torch.core.calibrate import calibrate
from repro_torch.core.context import QuantCtx
from repro_torch.core.muxq import QuantConfig
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.data.synthetic import corpus
from repro_torch.models import transformer as T
from repro_torch.models.common import cross_entropy
from repro_torch.models.surgery import inject_outliers, pick_outlier_channels
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

PPL_RTOL = 1e-4
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
            vocab_size=300)
A6 = dict(act_bits=6, weight_bits=8, act_granularity="per_tensor",
          outlier_mode="static", exp_factor=2)
# (method, quant kwargs): the evaluations the claims below make
GRID = {"naive_a6": ("naive", A6), "muxq_a6": ("muxq", A6),
        "llm_int8_a6": ("llm_int8", A6),
        "naive_a8": ("naive", {**A6, "act_bits": 8}),
        "muxq_a8": ("muxq", {**A6, "act_bits": 8}),
        "naive_a6_per_token": ("naive", {**A6,
                                         "act_granularity": "per_token"})}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the port's computations here take seconds at
    this size, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    cfg = get_config("gpt2-small", reduced=True).replace(**TINY)
    tr = Trainer(cfg, TrainConfig(steps=120, log_every=40, ckpt_dir=None),
                 PipelineConfig(seq_len=64, global_batch=8),
                 AdamWConfig(lr=3e-3, total_steps=120, warmup_steps=10),
                 device="cpu")
    out = tr.run()
    params = inject_outliers(cfg, tr.params,
                             pick_outlier_channels(cfg, 4, seed=1), 20.0)
    pipe = TokenPipeline(PipelineConfig(seq_len=64, global_batch=8, seed=99),
                         text=corpus(2000, seed=9))
    batches = [pipe.batch_at(i) for i in range(3)]
    _, masks, smooths = calibrate(
        lambda p, b, ctx: T.forward(cfg, p, torch.as_tensor(b["tokens"]), ctx),
        params, batches[:1])
    return cfg, params, tr.params, masks, smooths, batches, out


def _ppl(cfg, params, quant, masks, smooths, batches):
    ctx = (None if quant is None
           else QuantCtx(quant, device="cpu", masks=masks, smooths=smooths))
    losses = []
    with torch.no_grad():
        for b in batches:
            o = T.forward(cfg, params, torch.as_tensor(b["tokens"]), ctx)
            losses.append(float(cross_entropy(
                o["logits"], torch.as_tensor(b["labels"]), cfg.vocab_size)))
    return float(np.exp(np.mean(losses)))


def _grid_ppl(trained, name):
    cfg, params, _, masks, smooths, batches, _ = trained
    method, kw = GRID[name]
    return _ppl(cfg, params, QuantConfig(method=method, **kw), masks,
                smooths, batches)


def test_training_lowers_the_loss(trained):
    hist = trained[-1]["history"]
    assert [h["step"] for h in hist] == [40, 80, 120]
    assert hist[-1]["loss"] < hist[0]["loss"] < np.log(TINY["vocab_size"])


def test_outlier_injection_preserves_function(trained):
    cfg, params_out, params_clean, masks, smooths, batches, _ = trained
    p1 = _ppl(cfg, params_clean, None, masks, smooths, batches)
    p2 = _ppl(cfg, params_out, None, masks, smooths, batches)
    assert abs(p1 - p2) / p1 < 2e-3, (p1, p2)


def test_outliers_are_detected(trained):
    masks = trained[3]
    n_hit = sum(int(np.sum(m)) for m in masks.values())
    assert n_hit > 0, "injected outliers must trip the |x|>6 criterion"


def test_table1_ordering(trained):
    """naive > muxq >= llm.int8 >= fp at the paper's per-tensor IA6 point."""
    cfg, params, _, masks, smooths, batches, _ = trained
    ppl_fp = _ppl(cfg, params, None, masks, smooths, batches)
    ppl = {m: _grid_ppl(trained, f"{m}_a6")
           for m in ("naive", "muxq", "llm_int8")}
    assert ppl["naive"] > ppl["muxq"], ppl
    assert ppl["muxq"] >= ppl["llm_int8"] * 0.98, ppl
    assert ppl["llm_int8"] >= ppl_fp * 0.98, (ppl, ppl_fp)
    assert ppl["muxq"] < ppl_fp * 1.5


def test_gap_grows_with_lower_bits(trained):
    gap6 = _grid_ppl(trained, "naive_a6") - _grid_ppl(trained, "muxq_a6")
    gap8 = _grid_ppl(trained, "naive_a8") - _grid_ppl(trained, "muxq_a8")
    assert gap6 > gap8 - 1e-6, "muxq advantage should grow as bits drop"


def test_per_token_beats_per_tensor(trained):
    """Finer granularity robustness (paper §4.4)."""
    assert (_grid_ppl(trained, "naive_a6_per_token")
            <= _grid_ppl(trained, "naive_a6") + 1e-6)


@pytest.fixture(scope="module")
def reference(trained):
    """The reference's calibration of the port's trained, injected
    weights (its stacked layout)."""
    cfg, params, _, _, _, batches, _ = trained
    jcfg = jget_config("gpt2-small", reduced=True).replace(**TINY)
    jparams = to_reference_layout(params)
    _, masks, smooths = jcalibrate(
        lambda p, b, ctx: JT.forward(jcfg, p, jnp.asarray(b["tokens"]), ctx,
                                     scan=False),
        jparams, batches[:1])
    return jcfg, jparams, masks, smooths


def _jppl(reference, quant, batches):
    jcfg, jparams, masks, smooths = reference
    ctx = None if quant is None else JQuantCtx(quant, masks, smooths)
    losses = []
    for b in batches:
        o = JT.forward(jcfg, jparams, jnp.asarray(b["tokens"]), ctx,
                       scan=False)
        losses.append(float(jcross_entropy(o["logits"],
                                           jnp.asarray(b["labels"]),
                                           jcfg.vocab_size)))
    return float(np.exp(np.mean(losses)))


def test_reference_calibration_finds_the_same_outliers(trained, reference):
    masks = trained[3]
    jmasks = reference[2]
    assert set(masks) == set(jmasks)
    for site, m in masks.items():
        np.testing.assert_array_equal(np.asarray(m), np.asarray(jmasks[site]),
                                      err_msg=site)


@pytest.mark.parametrize("name", ["fp"] + sorted(GRID))
def test_perplexity_matches_reference(trained, reference, name):
    cfg, params, _, masks, smooths, batches, _ = trained
    if name == "fp":
        got = _ppl(cfg, params, None, masks, smooths, batches)
        want = _jppl(reference, None, batches)
    else:
        method, kw = GRID[name]
        got = _grid_ppl(trained, name)
        want = _jppl(reference, JQuantConfig(method=method, **kw), batches)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)
