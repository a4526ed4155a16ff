"""Kernel-level parity of the PyTorch port against the JAX reference.

The same seeded numpy inputs go through the reference (``repro``, on the
CPU as its own tests run it) and the port (``repro_torch``, plain PyTorch
versions on CPU tensors).  Integer results (int8 codes, int32
accumulators, packed buffers) must be bit-exact; float results match
within the tolerance stated at each test.  The CUDA kernels are held
against the plain versions in ``test_torch_cuda.py``.
"""
import ast
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.muxq import QuantConfig as JQuantConfig
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_ref as jpaged_ref
from repro.serve.kvcache import quantize_kv as jquantize_kv
from repro_torch.core.context import QuantCtx
from repro_torch.core.muxq import QuantConfig
from repro_torch.kernels import build, dispatch, ops
from repro_torch.kernels import muxq_gemm as G
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import quantize as RQ
from repro_torch.kernels.muxq_gemm import accumulate_plain, muxq_gemm
from repro_torch.kernels.quantize import rowwise_quantize
from repro_torch.serve.kvcache import quantize_kv
from repro_torch.serve.kvq import Int4KVQuantizer

REPO = Path(__file__).resolve().parents[1]

CFG = dict(method="muxq", outlier_mode="static", act_granularity="per_token",
           weight_granularity="per_channel", backend="fused")


def _to_jax(x: np.ndarray, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _to_torch(x: np.ndarray, dtype):
    return torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _outlier_x(rng, m, k, idx, mag=40.0):
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, idx] *= mag
    return x


# ---------------------------------------------------------------------------
# rowwise_quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 5, 64])
def test_rowwise_quantize_plain_bit_exact(dtype, m):
    rng = np.random.default_rng(m)
    x = _outlier_x(rng, m, 96, [3, 50])
    qj, sj = jref.rowwise_quantize_ref(_to_jax(x, dtype), 8)
    qt, st = rowwise_quantize(_to_torch(x, dtype), 8)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_rowwise_quantize_half_ties_round_to_even():
    # amax 127 -> scale exactly 1.0, so x / scale lands on exact .5 ties
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.0]],
                 np.float32)
    qj, _ = jref.rowwise_quantize_ref(jnp.asarray(x), 8)
    qt, st = rowwise_quantize(torch.from_numpy(x), 8)
    assert st.item() == 1.0
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_body_quantize_matches_permute_pad_shift(dtype):
    """The gather + 2^-e shift fused into the quantize (incl. the cast
    back to x's dtype) gives the reference's codes."""
    rng = np.random.default_rng(1)
    k = 192
    w = rng.standard_normal((k, 32)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[[7, 100, 150]] = True
    x = _outlier_x(rng, 6, k, np.nonzero(mask)[0])
    jmw = jops.prepare_weights(jnp.asarray(w), mask, 3, bk=64)
    body = jops._permute_pad_shift(_to_jax(x, dtype), jmw)
    qj, sj = jref.rowwise_quantize_ref(body, 8)
    mw = ops.prepare_weights(w, mask, 3, bk=64)
    qt, st = rowwise_quantize(_to_torch(x, dtype), 8, gather_idx=mw.gather_idx,
                              in_scale=mw.in_scale)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_rowwise_quantize_rejects_half_fused_args():
    with pytest.raises(ValueError, match="together"):
        rowwise_quantize(torch.zeros(2, 4), 8, gather_idx=torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# muxq_gemm
# ---------------------------------------------------------------------------

def _gemm_inputs(seed, m, k, n, bk, e=3, n_out_blocks=1, small=False):
    rng = np.random.default_rng(seed)
    hi = 8 if small else 128
    x = rng.integers(-hi + 1, hi, (m, k)).astype(np.int8)
    w = rng.integers(-hi + 1, hi, (k, n)).astype(np.int8)
    bs = np.ones(k // bk, np.int32)
    bs[:n_out_blocks] = 2 ** e
    sx = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    return x, w, bs, sx, sw


@pytest.mark.parametrize("m,k,n,bk", [(1, 256, 48, 64), (7, 512, 96, 128),
                                      (33, 1024, 80, 512)])
def test_muxq_gemm_int32_accumulator_exact(m, k, n, bk):
    """int32-exact before dequant, with a non-empty 2^3 outlier block.
    Small codes keep |acc| < 2^24, so the reference's f32 output with unit
    scales IS its int32 accumulator."""
    x, w, bs, _, _ = _gemm_inputs(m, m, k, n, bk, small=True)
    ones_m, ones_n = np.ones((m, 1), np.float32), np.ones((1, n), np.float32)
    acc = accumulate_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bs), bk)
    assert acc.dtype == torch.int32 and int(acc.abs().max()) < 2 ** 24
    for fn in (jref.muxq_gemm_ref, jref.muxq_gemm_two_matmul_ref):
        yj = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bs),
                           jnp.asarray(ones_m), jnp.asarray(ones_n), bk))
        np.testing.assert_array_equal(acc.numpy(), yj.astype(np.int32))


@pytest.mark.parametrize("m,k,n,bk", [(4, 1024, 64, 512), (9, 512, 40, 256)])
def test_muxq_gemm_plain_bit_exact_vs_reference(m, k, n, bk):
    """Full-range int8 codes and real scales: the dequantized f32 output
    (acc * sx * sw, in that order) equals the reference's bit for bit."""
    x, w, bs, sx, sw = _gemm_inputs(100 + m, m, k, n, bk)
    yj = np.asarray(jref.muxq_gemm_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(bs), jnp.asarray(sx),
                                       jnp.asarray(sw), bk))
    yt = muxq_gemm(*(torch.from_numpy(a) for a in (x, w, bs, sx, sw)), bk=bk)
    np.testing.assert_array_equal(yt.numpy(), yj)


@pytest.mark.parametrize("m,k,n,bk,blocks", [(4, 1024, 64, 512, 1),
                                             (9, 512, 40, 128, 2),
                                             (20, 1536, 24, 512, 3)])
def test_muxq_gemm_two_matmul_ref_is_a_second_oracle(m, k, n, bk, blocks):
    """The literal paper form Y_body + (2^e - 1) Y_aux, full-range codes and
    real scales: bit-equal to the reference's two-matmul oracle and to the
    port's one-GEMM oracle (``muxq_gemm_ref``, the plain version)."""
    from repro_torch.kernels import ref as tref
    x, w, bs, sx, sw = _gemm_inputs(200 + m, m, k, n, bk, e=2,
                                    n_out_blocks=blocks)
    args = [torch.from_numpy(a) for a in (x, w, bs, sx, sw)]
    two = tref.muxq_gemm_two_matmul_ref(*args, bk)
    yj = np.asarray(jref.muxq_gemm_two_matmul_ref(
        *(jnp.asarray(a) for a in (x, w, bs, sx, sw)), bk))
    assert two.dtype == torch.float32
    np.testing.assert_array_equal(two.numpy(), yj)
    np.testing.assert_array_equal(two.numpy(),
                                  tref.muxq_gemm_ref(*args, bk).numpy())


# ---------------------------------------------------------------------------
# Offline packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,outliers,k_pad_to", [
    (64, 48, [], None), (200, 32, [3, 17, 150], None),
    (96, 40, list(range(0, 96, 5)), 192)])
def test_pack_site_buffer_matches_reference(k, n, outliers, k_pad_to):
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[outliers] = True
    bk = 32
    jcfg, cfg = JQuantConfig(**CFG), QuantConfig(**CFG)
    bj = jdispatch.pack_site_buffer(jnp.asarray(w), mask, jcfg, bk=bk,
                                    k_pad_to=k_pad_to)
    bt = dispatch.pack_site_buffer(torch.from_numpy(w), mask, cfg, bk=bk,
                                   k_pad_to=k_pad_to)
    assert set(bt) == set(bj) == set(dispatch.BUFFER_FIELDS)
    for f in dispatch.BUFFER_FIELDS:
        assert bt[f].dtype == np.asarray(bj[f]).dtype, f
        np.testing.assert_array_equal(bt[f], np.asarray(bj[f]), err_msg=f)
    mw, jmw = ops.prepare_weights(w, mask, 2, bk=bk), jops.prepare_weights(
        jnp.asarray(w), mask, 2, bk=bk)
    assert (mw.n_out, mw.pad_out, mw.pad_tail) == (jmw.n_out, jmw.pad_out,
                                                   jmw.pad_tail)
    np.testing.assert_array_equal(mw.perm, np.asarray(jmw.perm))


def test_pad_buffer_to_matches_reference():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    mask = np.zeros(64, bool)
    mask[[1, 2]] = True
    buf = dispatch.pack_site_buffer(w, mask, QuantConfig(**CFG), bk=32)
    pt = dispatch.pad_buffer_to(buf, 160)
    pj = jdispatch.pad_buffer_to(buf, 160)
    for f in dispatch.BUFFER_FIELDS:
        np.testing.assert_array_equal(pt[f], np.asarray(pj[f]))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    y0 = dispatch.fused_matmul(x, dispatch.buffer_to(buf, "cpu"))
    y1 = dispatch.fused_matmul(x, dispatch.buffer_to(pt, "cpu"))
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The served weight layout: one k-major int8 copy per site
# ---------------------------------------------------------------------------

def test_buffer_to_keeps_the_reference_buffers_k_major():
    """The reference's packed buffer, moved by ``buffer_to``: every field
    equals the reference's array; the weight is the transposed view of one
    contiguous W^T (one int8 copy), and the fused path on it gives the
    reference's ``muxq_linear_ref`` output bit for bit."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((200, 48)).astype(np.float32)
    mask = np.zeros(200, bool)
    mask[[3, 17, 150]] = True
    bj = jdispatch.pack_site_buffer(jnp.asarray(w), mask, JQuantConfig(**CFG),
                                    bk=64)
    moved = dispatch.buffer_to({f: np.asarray(v) for f, v in bj.items()}, "cpu")
    for f in dispatch.BUFFER_FIELDS:
        np.testing.assert_array_equal(moved[f].numpy(), np.asarray(bj[f]),
                                      err_msg=f)
    wi = moved["w_int"]
    assert wi.T.is_contiguous() and not wi.is_contiguous()
    assert wi.untyped_storage().nbytes() == wi.numel()
    x = rng.standard_normal((5, 200)).astype(np.float32)
    yj = jops.muxq_linear_ref(jnp.asarray(x), jdispatch.as_muxq_weights(
        {f: jnp.asarray(v) for f, v in bj.items()}))
    yt = dispatch.fused_matmul(torch.from_numpy(x), moved)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_quant_ctx_holds_one_k_major_int8_weight_per_site():
    """A ``QuantCtx`` over four packed sites holds K_pad x N int8 bytes a
    site and no more: the weight's k-major copy is its only int8 tensor."""
    rng = np.random.default_rng(12)
    bufs = {}
    for i, (k, n) in enumerate([(96, 40), (200, 32), (64, 72), (130, 16)]):
        mask = np.zeros(k, bool)
        mask[rng.choice(k, 3, replace=False)] = True
        w = rng.standard_normal((k, n)).astype(np.float32)
        bufs[f"layer{i}/mlp_up"] = dispatch.pack_site_buffer(
            w, mask, QuantConfig(**CFG), bk=32)
    ctx = QuantCtx(QuantConfig(**CFG), device="cpu", kernel_buffers=bufs)
    total = 0
    for site, buf in ctx.kernel_buffers.items():
        np.testing.assert_array_equal(buf["w_int"].numpy(), bufs[site]["w_int"])
        assert buf["w_int"].T.is_contiguous()
        int8 = [t for t in buf.values() if t.dtype == torch.int8]
        assert len(int8) == 1
        total += int8[0].untyped_storage().nbytes()
    assert total == sum(b["w_int"].size for b in bufs.values())


def test_muxq_gemm_launch_takes_only_a_k_major_weight(monkeypatch):
    """``_launch`` (what a CUDA tensor reaches) refuses an n-major weight and
    a k-major view whose rows are not packed with a clear error, and hands a k-major one to the
    kernel as it is, without a copy.  A stub stands in for the kernel
    library, so no card is needed."""
    calls = []
    monkeypatch.setattr(build, "launcher",
                        lambda name: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    x, w, bs, sx, sw = (torch.from_numpy(a)
                        for a in _gemm_inputs(1, 4, 1024, 64, 512))
    strided = torch.cat([w.T, w.T], 1)[:, :1024].T   # rows of W^T 2K apart
    for bad in (w, strided):
        with pytest.raises(ValueError, match="k-major"):
            G._launch(x, bad, bs, sx, sw, 512)
    assert not calls
    w_t = w.T.contiguous()
    before = G.LAUNCHES
    G._launch(x, w_t.T, bs, sx, sw, 512)
    assert G.LAUNCHES == before + 1 and len(calls) == 1
    assert calls[0][1] == w_t.data_ptr()
    assert calls[0][6:11] == (4, 64, 1024, 512, 132)   # M, N, K, bk, SMs


def _expert_buffer(seed, e=3, k=200, n=48, bk=64):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[[3, 17, 150]] = True
    bj = jdispatch.pack_site_buffer(jnp.asarray(w), mask, JQuantConfig(**CFG),
                                    bk=bk)
    return mask, {f: np.asarray(v) for f, v in bj.items()}


def test_buffer_to_gives_each_expert_a_k_major_slab():
    """A per-expert buffer [E, K_pad, N] (the reference's), moved by
    ``buffer_to``: every field equals the reference's array; each expert's
    weight is the transposed view of its own contiguous [N, K_pad] slab of
    one int8 copy; ``fused_emm`` on it (plain versions, and the oracle
    form) gives the reference's ``fused_emm`` output bit for bit."""
    mask, bj = _expert_buffer(13)
    moved = dispatch.buffer_to(bj, "cpu")
    for f in dispatch.BUFFER_FIELDS:
        np.testing.assert_array_equal(moved[f].numpy(), bj[f], err_msg=f)
    wi = moved["w_int"]
    assert wi.shape == bj["w_int"].shape and moved["sw"].shape == (3, 1, 48)
    assert wi.untyped_storage().nbytes() == wi.numel()
    k_pad = wi.shape[1]
    for e in range(wi.shape[0]):
        assert wi[e].T.is_contiguous()
        assert wi[e].data_ptr() == wi.data_ptr() + e * k_pad * wi.shape[2]
    rng = np.random.default_rng(14)
    x = rng.standard_normal((3, 5, 200)).astype(np.float32)
    x[..., mask] *= 40.0
    yj = np.asarray(jdispatch.fused_emm(jnp.asarray(x), {
        f: jnp.asarray(v) for f, v in bj.items()}))
    yt = dispatch.fused_emm(torch.from_numpy(x), moved)
    np.testing.assert_array_equal(yt.numpy(), yj)
    prev = dispatch.set_fused_impl("ref")
    try:
        np.testing.assert_array_equal(
            dispatch.fused_emm(torch.from_numpy(x), moved).numpy(), yj)
    finally:
        dispatch.set_fused_impl(prev)


def test_pack_site_buffer_per_expert_matches_reference():
    """[E, K, N] packs per expert with one channel map, bit-equal to the
    reference's; padding to a wider K_pad pads every expert."""
    rng = np.random.default_rng(15)
    w = rng.standard_normal((4, 96, 40)).astype(np.float32)
    mask = np.zeros(96, bool)
    mask[[1, 50]] = True
    bt = dispatch.pack_site_buffer(torch.from_numpy(w), mask,
                                   QuantConfig(**CFG), bk=32)
    bj = jdispatch.pack_site_buffer(jnp.asarray(w), mask, JQuantConfig(**CFG),
                                    bk=32)
    assert bt["w_int"].shape == (4, 128, 40) and bt["sw"].shape == (4, 1, 40)
    pt, pj = dispatch.pad_buffer_to(bt, 192), jdispatch.pad_buffer_to(bj, 192)
    for f in dispatch.BUFFER_FIELDS:
        np.testing.assert_array_equal(bt[f], np.asarray(bj[f]), err_msg=f)
        np.testing.assert_array_equal(pt[f], np.asarray(pj[f]), err_msg=f)


def test_fused_emm_launches_one_quantize_and_a_gemm_per_expert(monkeypatch):
    """What CUDA tensors reach in ``fused_emm``: one ``rowwise_quantize``
    launch over all experts' rows [E*C, K], then E ``muxq_gemm`` launches,
    expert e's on its rows of the codes and scales, its own k-major slab
    and its own ``sw`` row, each without a copy.  The wrappers' launch
    paths run with a stub kernel library, so no card is needed."""
    calls = []
    monkeypatch.setattr(build, "launcher",
                        lambda name: lambda *a: calls.append((name, a)) or 0)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(ops, "rowwise_quantize",
                        lambda x, bits, gather_idx, in_scale: RQ._launch(
                            x, bits, gather_idx, in_scale))
    monkeypatch.setattr(ops, "muxq_gemm", lambda *a, bk: G._launch(*a, bk))
    _, bj = _expert_buffer(16, e=3, k=256, n=48)
    buf = dispatch.buffer_to(bj, "cpu")
    n_e, c, k_pad = 3, 8, buf["w_int"].shape[1]
    before = (RQ.LAUNCHES, G.LAUNCHES)
    y = dispatch.fused_emm(torch.zeros(n_e, c, 256), buf)
    assert y.shape == (n_e, c, 48)
    assert (RQ.LAUNCHES - before[0], G.LAUNCHES - before[1]) == (1, n_e)
    assert [name for name, _ in calls] == ["rowwise_quantize"] + ["muxq_gemm"] * n_e
    q_args = calls[0][1]
    assert q_args[5:8] == (n_e * c, 256, k_pad)          # M, K in, K out
    q_ptr, s_ptr = q_args[3], q_args[4]
    for e, (_, a) in enumerate(calls[1:]):
        assert a[0] == q_ptr + e * c * k_pad             # expert e's codes
        assert a[1] == buf["w_int"][e].data_ptr()        # its own slab
        assert a[3] == s_ptr + e * c * 4                 # its rows' scales
        assert a[4] == buf["sw"][e].data_ptr()           # its sw row
        assert a[6:10] == (c, 48, k_pad, 64)             # M, N, K, bk


def test_fused_dynamic_outliers_cannot_pack():
    with pytest.raises(ValueError, match="static"):
        dispatch.pack_site_buffer(np.zeros((8, 4), np.float32), None,
                                  QuantConfig(**{**CFG, "outlier_mode": "dynamic"}))
    with pytest.raises(ValueError, match="no fused kernel"):
        dispatch.site_backend(QuantConfig(method="llm_int8", backend="fused"))


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------

def _paged_inputs(seed, *, b=3, sq=1, h=4, kvh=2, dh=16, ps=4, n_pages=10, P=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    # ragged tables: slot 0 full, slot 1 short (tail -> scratch page 0),
    # slot 2 idle (all scratch page 0, position 0)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)[:b, :P]
    pos = np.array([P * ps - sq, 5, 0], np.int32)[:b]
    return q, k, v, table, pos


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
def test_paged_attention_plain_matches_reference(mode, sq):
    """atol 1e-5 in f32: same gather/mask/softmax sequence, only the
    summation order of the two einsums can differ between frameworks."""
    q, k, v, table, pos = _paged_inputs(sq, sq=sq)
    kw_j, kw_t = {}, {}
    if mode == "int8":
        qkv = jquantize_kv(jnp.asarray(k), jnp.asarray(v))
        kj, vj = qkv["k"], qkv["v"]
        kw_j = {"k_scale": qkv["k_scale"], "v_scale": qkv["v_scale"]}
        tq = quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
        np.testing.assert_array_equal(tq["k"].numpy(), np.asarray(kj))
        np.testing.assert_array_equal(tq["v_scale"].numpy(),
                                      np.asarray(kw_j["v_scale"]))
        kt, vt = tq["k"], tq["v"]
        kw_t = {"k_scale": tq["k_scale"], "v_scale": tq["v_scale"]}
    else:
        kj, vj = jnp.asarray(k), jnp.asarray(v)
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    qj = jnp.asarray(q[:, 0] if sq == 1 else q)
    qt = torch.from_numpy(q[:, 0] if sq == 1 else q)
    oj = np.asarray(jpaged_ref(qj, kj, vj, jnp.asarray(table), jnp.asarray(pos),
                               **kw_j))
    ot = PA.paged_attention_decode(qt, kt, vt, torch.from_numpy(table),
                                   torch.from_numpy(pos), **kw_t)
    assert ot.shape == tuple(oj.shape)
    assert torch.isfinite(ot).all()
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0, atol=1e-5)


def test_paged_attention_window_and_softcap_match_reference():
    q, k, v, table, pos = _paged_inputs(7, sq=2)
    oj = np.asarray(jpaged_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(table), jnp.asarray(pos), window=5,
                               softcap=3.0))
    ot = PA.paged_attention_decode(*(torch.from_numpy(a) for a in
                                     (q, k, v, table, pos)), window=5,
                                   softcap=3.0)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0, atol=1e-5)


def test_paged_impl_selection_and_int4_refusal():
    """Unknown impls are refused; int4 pages, refused by the first slice,
    are now read: the result equals attention over the pages' dequantized
    values (atol 1e-5, f32)."""
    with pytest.raises(ValueError, match="unknown paged impl"):
        PA.set_paged_impl("pallas")
    prev = PA.set_paged_impl("ref")
    assert PA.set_paged_impl(prev) == "ref"
    q, k, v, table, pos = _paged_inputs(0)
    redist = torch.ones(2, 16)
    redist[0, 3] = 4.0
    quant = Int4KVQuantizer(redist, redist)
    parts = quant.quantize(torch.from_numpy(k), torch.from_numpy(v))
    assert parts["k"].shape == (10, 4, 2, 8) and parts["k_scale"].dtype == torch.bfloat16
    tq, tt, tp = (torch.from_numpy(a) for a in (q, table, pos))
    o4 = PA.paged_attention_decode(tq[:, 0], parts["k"], parts["v"], tt, tp,
                                   k_scale=parts["k_scale"],
                                   v_scale=parts["v_scale"], k_redist=redist,
                                   v_redist=redist)
    kd, vd = quant.dequantize(parts, torch.float32)
    od = PA.paged_attention_decode(tq[:, 0], kd, vd, tt, tp)
    np.testing.assert_allclose(o4.numpy(), od.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Import guard: the port and chip_smoke.py never import JAX or the reference
# ---------------------------------------------------------------------------

def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    port = {f.relative_to(REPO / "src" / "repro_torch").as_posix() for f in files[:-1]}
    assert {"core/llm_int8.py", "core/smoothquant.py", "core/prequant.py",
            "data/pipeline.py", "data/synthetic.py", "launch/serve.py"} <= port
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad
