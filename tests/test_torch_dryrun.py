"""The port's dry-run against the JAX reference (``repro_torch/launch/
specs.py`` and ``dryrun.py``), and two faults the dry-run found.

Every spec leaf, ``cell_supported`` and ``synthetic_qparams`` equal the
reference's at full width (its leaves from ``jax.eval_shape``, the
port's on the meta device).  The reference test's ten (arch, mode) cells
trace at REDUCED on a fake (2, 4) world (opened and destroyed in a
fixture: other files in the same worker expect no process group); the
kernel sites count the same with their plain versions, with a stub
kernel launcher and on the meta device; a failing cell is recorded, and
``main`` returns 1.  ``lower_paged_cell`` equals the reference's, which
runs as its own test runs it (a subprocess with placeholder devices).
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jget_config
from repro.launch import specs as JSP
from repro.launch import steps as JS
from repro.models import transformer as JT

from repro_torch import quantize as Q
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.core.context import QuantCtx
from repro_torch.kernels import build, dispatch
from repro_torch.kernels import muxq_gemm as G
from repro_torch.kernels import quantize as RQ
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH

REPO = Path(__file__).resolve().parents[1]
ALL = list(ARCHS)      # the 10 assigned archs and gpt2-small
BF16_RTOL = 2e-2       # bf16 decode logits, port vs reference, of the
                       # logits' scale: bf16 rounding of the conv and
                       # projections in other orders

REF_CELLS = [          # tests/test_dryrun.py's cells
    ("qwen2-0.5b", "train"), ("gemma2-9b", "train"), ("dbrx-132b", "train"),
    ("mamba2-370m", "train"), ("zamba2-1.2b", "train"),
    ("whisper-tiny", "train"), ("internvl2-2b", "prefill"),
    ("qwen2-0.5b", "decode"), ("mamba2-370m", "decode"),
    ("llama4-scout-17b-a16e", "prefill"),
]


@pytest.fixture
def world():
    """Opens a fake world on request; destroyed after the test."""
    def open_(size):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    yield open_
    if dist.is_initialized():
        dist.destroy_process_group()


def _torch_dtype(jdt):
    return getattr(torch, jnp.dtype(jdt).name)


def _same_leaves(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        g, w = got[k], want[k]
        assert tuple(g.shape) == tuple(w.shape), (where, k)
        assert g.dtype == _torch_dtype(w.dtype), (where, k)
        assert g.device.type == "meta", (where, k)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_spec_leaves_equal_reference(arch):
    """Every leaf of the batch, prefill, cache (bf16 and int8 KV) and
    decode specs, for the four shapes at full width; ``cell_supported``
    the same."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list(SP.SHAPES) == list(JSP.SHAPES)
    for name, shape in SP.SHAPES.items():
        jshape = JSP.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.mode) == \
            (jshape.seq_len, jshape.global_batch, jshape.mode)
        assert SP.cell_supported(cfg, shape) == \
            JSP.cell_supported(jcfg, jshape)
        where = (arch, name)
        _same_leaves(SP.batch_specs_abstract(cfg, shape),
                     JSP.batch_specs_abstract(jcfg, jshape), where)
        _same_leaves(SP.prefill_specs_abstract(cfg, shape),
                     JSP.prefill_specs_abstract(jcfg, jshape), where)
        for int8 in (False, True):
            got = SP.decode_specs_abstract(cfg, shape, int8_kv=int8)
            want = JSP.decode_specs_abstract(jcfg, jshape, int8_kv=int8)
            _same_leaves(got["cache"], want["cache"], where + (int8,))
            _same_leaves({"t": got["tokens"]}, {"t": want["tokens"]}, where)


@pytest.mark.parametrize("arch", ALL)
def test_synthetic_qparams_bit_equal(arch):
    got = SP.synthetic_qparams(get_config(arch))
    want = JSP.synthetic_qparams(jget_config(arch))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-scout-17b-a16e",
                                  "dbrx-132b", "mamba2-370m", "zamba2-1.2b",
                                  "whisper-tiny"])
def test_the_ctx_sees_the_masks_sites(arch):
    """The fused artifact built on ``eager_masks`` (meta buffers): the
    sites a forward runs are the masks' sites, plus whisper's encoder
    (which the reference's masks do not cover), and each site's mask is
    its stacked row."""
    cfg = get_config(arch, reduced=True).replace(dtype="bfloat16")
    qp = SP.synthetic_qparams(cfg)
    masks = SP.eager_masks(cfg, qp)
    params = T.init_params(cfg, device="meta")
    art = D.fused_artifact(cfg, params, masks, "meta")
    ctx = QuantCtx(art, device="meta")
    extra = ({"frames": torch.empty(1, cfg.n_audio_frames, cfg.d_model,
                                    device="meta")}
             if cfg.is_enc_dec else None)
    T.forward(cfg, Q.stub_weights(params,
                                  Q.fused_sites(cfg, params, art.policy)),
              torch.empty(1, 8, dtype=torch.int32, device="meta"), ctx,
              extra=extra)
    seen = set(ctx.backend_log)
    assert set(masks) <= seen
    assert all(s.startswith("enc") for s in seen - set(masks))
    assert set(ctx.backend_log.values()) == {"fused"}
    assert set(art.kernel_buffers) == seen
    name = "shared0/attn_qkv" if cfg.family == "hybrid" else (
        "layer1/ssm_out" if cfg.family == "ssm" else "layer1/attn_out")
    row = cfg.shared_attn_every - 1 if cfg.family == "hybrid" else 1
    base = name.split("/")[1]
    np.testing.assert_array_equal(masks[name], qp[base][row])


def test_abstract_buffers_match_packed_ones():
    """``abstract_site_buffer`` gives what ``pack_site_buffer`` +
    ``buffer_to`` give: shapes, dtypes and the k-major weight, for a
    dense and a per-expert site and empty, short and long outlier runs."""
    qcfg = ST.MUXQ_FUSED_SERVE
    rng = np.random.default_rng(0)
    for shape in ((96, 40), (3, 96, 40), (700, 24)):
        k = shape[-2]
        for n_out in (0, 3, min(k, 600)):
            mask = np.zeros(k, bool)
            mask[rng.choice(k, n_out, replace=False)] = True
            w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            real = dispatch.buffer_to(dispatch.pack_site_buffer(w, mask, qcfg),
                                      "cpu")
            fake = dispatch.abstract_site_buffer(shape, n_out, device="meta")
            for f in dispatch.BUFFER_FIELDS:
                assert fake[f].shape == real[f].shape, (shape, n_out, f)
                assert fake[f].dtype == real[f].dtype, (shape, n_out, f)
            assert fake["w_int"].stride() == real["w_int"].stride()


# ---------------------------------------------------------------------------
# run_cell's program on a small world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", REF_CELLS)
def test_cell_traces_on_a_small_mesh(world, arch, mode):
    """The reference test's cells at REDUCED on a fake (2, 4) world:
    flops > 0 (but in decode, where the reference allows 0), the kernel
    sites reached on the serve cells, the collectives of the train cells
    recorded, and a roofline from the counts."""
    world(8)
    cfg = get_config(arch, reduced=True).replace(dtype="bfloat16", remat=True)
    mesh = M.make_mesh((2, 4), ("data", "model"), device="cpu")
    shape = SP.ShapeSpec("t", 32, 8, mode)
    quant = "fp" if mode == "train" else "muxq"
    out = D._compile_costs(cfg, shape, mesh, quant, fsdp=True,
                           seq_shard=mode == "train")
    assert out["cost"]["flops"] > 0 or mode == "decode"
    assert out["mem"]["peak_size_in_bytes"] >= \
        out["mem"]["argument_size_in_bytes"] > 0
    if mode == "train":
        assert out["coll"]["counts"]["all-gather"] > 0
        assert out["coll"]["counts"]["all-reduce"] > 0
        assert not out["kernels"]
    else:
        calls = out["kernels"]["rowwise_quantize"]["calls"]
        assert calls == out["kernels"]["muxq_gemm"]["calls"] - (
            (cfg.n_experts - 1) * 2 * cfg.n_layers if cfg.n_experts else 0)
        assert out["coll"]["total"] == 0
    from repro_torch.analysis import roofline as R
    roof = R.make_roofline(out["cost"], out["coll"], cfg, out["tokens"],
                           mode, 8)
    assert roof.step_s > 0
    assert not dist.is_initialized() or dist.get_world_size() == 8


def _stub_launchers(monkeypatch):
    """The wrappers' CPU path launches through ``_launch`` with a stub
    kernel library: the calls and counts of a card, no arithmetic."""
    monkeypatch.setattr(build, "launcher", lambda name: lambda *a: 0)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(RQ, "rowwise_quantize_plain",
                        lambda x, bits, gi, sc: RQ._launch(x, bits, gi, sc))
    monkeypatch.setattr(G, "muxq_gemm_plain",
                        lambda x, w, bs, sx, sw, bk: G._launch(x, w, bs, sx,
                                                               sw, bk))


def test_counts_equal_with_plain_versions_stub_kernels_and_meta(monkeypatch):
    """gpt2 REDUCED's decode cell program (a rank's 8 rows of a (2, 4)
    plan, fused MUXQ; its K-blocks fit the GEMM kernel's 64-wide K tile):
    the same flops, bytes and kernel-site counts on CPU tensors through
    the plain versions, through a stub kernel launcher (whose launches
    count one a site call), and on the meta device."""
    cfg = get_config("gpt2-small", reduced=True).replace(dtype="bfloat16")
    shape = SP.ShapeSpec("t", 64, 16, "decode")
    plan = {"data": 2, "model": 4}
    runs = {}
    for how in ("meta", "plain", "stub"):
        dev = "meta" if how == "meta" else "cpu"
        step, args, held, _ = D.serve_program(cfg, shape, plan, "muxq",
                                              device=dev)
        if how == "stub":
            _stub_launchers(monkeypatch)
        before = (RQ.LAUNCHES, G.LAUNCHES)
        out = D.trace(step, args, held)
        out["launches"] = (RQ.LAUNCHES - before[0], G.LAUNCHES - before[1])
        runs[how] = out
        monkeypatch.undo()
    n_sites = 4 * cfg.n_layers
    for how, out in runs.items():
        assert out["kernels"]["rowwise_quantize"]["calls"] == n_sites, how
        assert out["kernels"] == runs["plain"]["kernels"], how
        assert out["cost"] == runs["plain"]["cost"], how
        assert out["mem"]["argument_size_in_bytes"] == \
            runs["plain"]["mem"]["argument_size_in_bytes"], how
    assert runs["stub"]["launches"] == (n_sites, n_sites)
    assert runs["plain"]["launches"] == runs["meta"]["launches"] == (0, 0)


def test_run_cell_full_width_skip_error_and_main(monkeypatch, tmp_path):
    """At full width: a supported cell is ok (its own fake world of 256,
    closed after), long_500k on a dense arch is skipped for the
    reference's reason, a failing cell is recorded with its trace and
    ``main`` returns 1 on it (0 otherwise); records go to OUT_DIR."""
    monkeypatch.setattr(D, "OUT_DIR", tmp_path)
    rec = D.run_cell("whisper-tiny", "decode_32k", multi_pod=False,
                     quant="muxq", save=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert not dist.is_initialized()
    assert rec["chips"] == 256 and rec["corrected"] is False
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["kernels"]["muxq_gemm"]["calls"] > 0
    assert (tmp_path / "whisper-tiny_decode_32k_16-16_muxq.json").exists()
    skip = D.run_cell("qwen2-0.5b", "long_500k", multi_pod=False,
                      quant="muxq", save=False)
    assert skip["status"] == "skipped"
    assert skip["reason"] == JSP.cell_supported(
        jget_config("qwen2-0.5b"), JSP.SHAPES["long_500k"])[1]
    assert D.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                   "--no-save"]) == 0

    def broken(*a, **k):
        raise RuntimeError("injected fault")
    monkeypatch.setattr(D, "_compile_costs", broken)
    bad = D.run_cell("whisper-tiny", "decode_32k", multi_pod=False,
                     quant="muxq", save=False)
    assert bad["status"] == "error" and "injected fault" in bad["error"]
    assert "Traceback" in bad["trace"]
    assert not dist.is_initialized()
    assert D.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                   "--no-save"]) == 1


# ---------------------------------------------------------------------------
# the tensor-parallel dry-run
# ---------------------------------------------------------------------------

def _reference_paged_cells():
    code = textwrap.dedent("""
    import json
    from repro.launch.dryrun import lower_paged_cell
    out = []
    for arch in ("qwen1.5-110b", "dbrx-132b"):
        for tp in (2, 4):
            c = lower_paged_cell(arch, tp, kv_mode="int8")
            out.append({k: c[k] for k in ("arch", "tp", "n_kv_heads",
                "heads_sharded", "kv_shards", "cache_bytes",
                "cache_bytes_per_shard", "lowered")})
    print(json.dumps(out))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_lower_paged_cell_equals_reference():
    """qwen1.5-110b and dbrx-132b at tp 2 and 4 on int8 pages: the
    reference's head count, pool bytes and bytes a shard, and one pooled
    decode of a rank's shard run on meta tensors in a fake world."""
    for want in _reference_paged_cells():
        got = D.lower_paged_cell(want["arch"], want["tp"], kv_mode="int8")
        assert {k: got[k] for k in want} == want
        assert got["cache_bytes_per_shard"] == got["cache_bytes"] // got["tp"]
        assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# faults the dry-run found
# ---------------------------------------------------------------------------

def test_local_shard_holds_only_its_part():
    """A rank's shard is its own storage, not a view that keeps the whole
    tensor alive (a leading-dim shard of a contiguous tensor is a
    contiguous view, which ``.contiguous()`` returned as it was)."""
    t = torch.arange(32.0).reshape(8, 4)
    for spec, coord in (((("data",), None), {"data": 1}),
                        ((None, "data"), {"data": 0})):
        part = SH.local_shard(t, spec, {"data": 2}, coord)
        assert part.untyped_storage().nbytes() == 16 * 4
        np.testing.assert_array_equal(
            part.numpy(), t[SH.shard_slices(t.shape, spec, {"data": 2},
                                            coord)].numpy())
        assert part.is_contiguous()
    whole = SH.local_shard(t, (None, None), {"data": 2}, {"data": 0})
    assert whole.data_ptr() == t.data_ptr()


def test_bf16_ssm_decode_matches_reference():
    """mamba2 REDUCED in bf16: the prefill keeps the conv states f32, and
    the decode's conv then promotes, as the reference's einsum does (the
    port's raised "expected scalar type Float but found BFloat16")."""
    jcfg = jget_config("mamba2-370m", reduced=True).replace(dtype="bfloat16")
    cfg = get_config("mamba2-370m", reduced=True).replace(dtype="bfloat16")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    _, cache = ST.make_prefill_step(cfg, 12, device="cpu")(
        params, {"tokens": torch.as_tensor(toks[:, :8], dtype=torch.int32)})
    _, jcache = jax.jit(JS.make_prefill_step(jcfg, 12, scan=False))(
        jparams, {"tokens": jnp.asarray(toks[:, :8], jnp.int32)})
    assert cache["conv_x"].dtype == torch.float32
    with torch.no_grad():
        lg, _ = T.decode_step(cfg, params, torch.as_tensor(toks[:, 8:9]),
                              cache)
    jlg, _ = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c,
                                                    scan=False))(
        jparams, jnp.asarray(toks[:, 8:9], jnp.int32), jcache)
    got, want = lg.float().numpy(), np.asarray(jlg, np.float32)
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= BF16_RTOL * scale
