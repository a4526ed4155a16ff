"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``gpu`` and skips without a CUDA
device; run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, dispatch, ops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import muxq_gemm as G
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import quantize as RQ
from repro_torch.kernels.muxq_gemm import muxq_gemm
from repro_torch.kernels.quantize import rowwise_quantize, rowwise_quantize_plain
from repro_torch.serve.kvcache import quantize_kv
from repro_torch.serve.kvq import Int4KVQuantizer, redist_from_mask


def _outlier_x(rng, m, k, idx, mag=40.0):
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, idx] *= mag
    return x


def _gemm_inputs(seed, m, k, n, bk, e=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    bs = np.ones(k // bk, np.int32)
    bs[0] = 2 ** e
    sx = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    return x, w, bs, sx, sw


def _paged_inputs(seed, *, b=3, sq=1, h=4, kvh=2, dh=64, ps=16, n_pages=8, P=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    # ragged tables: full, short (tail -> scratch page 0), idle
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)[:b, :P]
    pos = np.array([P * ps - sq, 5, 0], np.int32)[:b]
    return q, k, v, table, pos



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a and run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rowwise_quantize_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((768, 8)).astype(np.float32)
    mask = np.zeros(768, bool)
    mask[rng.choice(768, 8, replace=False)] = True
    mw = ops.prepare_weights(w, mask, 3, bk=512)
    x = torch.from_numpy(_outlier_x(rng, 64, 768, np.nonzero(mask)[0])).to(cuda, dtype)
    g, s = mw.gather_idx.to(cuda), mw.in_scale.to(cuda)
    qk, sk = rowwise_quantize(x, 8, gather_idx=g, in_scale=s)
    qp, sp = rowwise_quantize(x.cpu(), 8, gather_idx=g.cpu(), in_scale=s.cpu())
    assert torch.equal(qk.cpu(), qp) and torch.equal(sk.cpu(), sp)
    # the plain version gives the same codes on the card as on the CPU
    qc, sc = rowwise_quantize_plain(x, 8, g, s)
    assert torch.equal(qc, qk) and torch.equal(sc, sk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(4, 768), (4, 896), (20, 896), (64, 768),
                                 (4, 3072), (4, 4864), (130, 4864), (2, 9000)])
def test_cuda_rowwise_quantize_serving_widths(cuda, dtype, m, k):
    """The fused body at both models' widths (K_pad 1536 to 5632) and one
    over the register budget (K_pad 9728 > 512 threads x 16 values, the
    loop that gathers twice), decode to prefill M: codes and scales equal
    the plain version's on the card."""
    rng = np.random.default_rng(k + m)
    w = rng.standard_normal((k, 4)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[rng.choice(k, 8, replace=False)] = True
    mw = ops.prepare_weights(w, mask, 3, bk=512)
    x = torch.from_numpy(_outlier_x(rng, m, k, np.nonzero(mask)[0])).to(cuda, dtype)
    g, s = mw.gather_idx.to(cuda), mw.in_scale.to(cuda)
    qk, sk = rowwise_quantize(x, 8, gather_idx=g, in_scale=s)
    qp, sp = rowwise_quantize_plain(x, 8, g, s)
    assert torch.equal(qk, qp) and torch.equal(sk, sp)
    # the scalar paths: unfused, and fused with a gather width that is not a
    # multiple of 4
    qk, sk = rowwise_quantize(x[:, : k - 3].contiguous(), 8)
    qp, sp = rowwise_quantize_plain(x[:, : k - 3], 8)
    assert torch.equal(qk, qp) and torch.equal(sk, sp)
    g3, s3 = g[3:].contiguous(), s[3:].contiguous()
    qk, sk = rowwise_quantize(x, 8, gather_idx=g3, in_scale=s3)
    qp, sp = rowwise_quantize_plain(x, 8, g3, s3)
    assert torch.equal(qk, qp) and torch.equal(sk, sp)


@pytest.mark.gpu
def test_cuda_plain_kv_quantize_matches_cpu(cuda):
    x = torch.randn(64, 16, 12, 64, generator=torch.Generator().manual_seed(0))
    on_card = quantize_kv(x.to(cuda), x.to(cuda))
    on_cpu = quantize_kv(x, x)
    for name, t in on_cpu.items():
        assert torch.equal(on_card[name].cpu(), t), name


@pytest.mark.gpu
def test_cuda_plain_int4_quantize_matches_cpu(cuda):
    """Int4 pages: bf16 scales and packed codes of the plain quantizer are
    the same on the card as on the CPU (the scale divides by a tensor)."""
    x = torch.randn(64, 16, 2, 64, generator=torch.Generator().manual_seed(1))
    redist = torch.ones(2, 64)
    redist[1, [3, 40]] = 4.0
    on_card = Int4KVQuantizer(redist.to(cuda), redist.to(cuda)).quantize(
        x.to(cuda), x.to(cuda))
    on_cpu = Int4KVQuantizer(redist, redist).quantize(x, x)
    for name, t in on_cpu.items():
        assert torch.equal(on_card[name].cpu(), t), name


def _on_card(cuda, x, w, bs, sx, sw):
    """GEMM operands on the card, the weight stored k-major as the served
    copy is (``dispatch.buffer_to``)."""
    return (torch.from_numpy(x).to(cuda), torch.from_numpy(w).T.contiguous().to(cuda).T,
            *(torch.from_numpy(a).to(cuda) for a in (bs, sx, sw)))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 1024, 2304), (4, 3584, 768), (64, 1024, 3072)])
def test_cuda_muxq_gemm_matches_plain(cuda, m, k, n):
    x, w, bs, sx, sw = _gemm_inputs(m, m, k, n, 512)
    args = [torch.from_numpy(a) for a in (x, w, bs, sx, sw)]
    yk = muxq_gemm(*_on_card(cuda, x, w, bs, sx, sw), bk=512)
    yp = muxq_gemm(*args, bk=512)
    assert torch.equal(yk.cpu(), yp)


# every site of the two served models: (K_pad, N) with a calibrated outlier
# run (K_pad one 512-block wider) and, for gpt2, without one
_SERVING_SITES = {
    "gpt2 attn_qkv": (1536, 2304), "gpt2 attn_out": (1536, 768),
    "gpt2 mlp_up": (1536, 3072), "gpt2 mlp_down": (3584, 768),
    "gpt2 attn_qkv plain": (1024, 2304), "gpt2 mlp_down plain": (3072, 768),
    "qwen2 attn_qkv": (1536, 1152), "qwen2 attn_out": (1536, 896),
    "qwen2 mlp_up": (1536, 9728), "qwen2 mlp_down": (5632, 896)}


@pytest.mark.gpu
@pytest.mark.parametrize("site", sorted(_SERVING_SITES))
@pytest.mark.parametrize("m", [4, 20, 64])
def test_cuda_muxq_gemm_serving_shapes_bit_equal(cuda, site, m):
    """Decode (4 slots), verify (4 slots x 5 rows) and prefill (2 chunks of
    32) at every serving site: bit-equal to the plain version on the card."""
    k, n = _SERVING_SITES[site]
    x, w, bs, sx, sw = _gemm_inputs(k + m, m, k, n, 512)
    args = _on_card(cuda, x, w, bs, sx, sw)
    assert torch.equal(muxq_gemm(*args, bk=512), G.muxq_gemm_plain(*args, 512))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 20, 64, 128, 130])
@pytest.mark.parametrize("k,n,bk", [(1536, 1000, 512), (5632, 72, 512),
                                    (1024, 776, 128)])
def test_cuda_muxq_gemm_ragged_bit_equal(cuda, m, k, n, bk):
    """Every row-block size (1 to 8 n8 tiles, several row blocks at 128 and
    130) with N not a multiple of the 64-column block, K-blocks of 128 and
    512 (a split's K range crosses blocks of 128)."""
    x, w, bs, sx, sw = _gemm_inputs(m * n, m, k, n, bk)
    args = _on_card(cuda, x, w, bs, sx, sw)
    assert torch.equal(muxq_gemm(*args, bk=bk), G.muxq_gemm_plain(*args, bk))


@pytest.mark.gpu
def test_cuda_muxq_gemm_repeated_and_across_streams(cuda):
    """Calls of different shapes and split counts back to back, a call on
    another stream, then the first call again, all bit-equal."""
    cases = [_on_card(cuda, *_gemm_inputs(s, m, k, n, 512))
             for s, (m, k, n) in enumerate([(4, 1536, 3072), (20, 5632, 896),
                                            (1, 1024, 768), (64, 1536, 2304)])]
    want = [G.muxq_gemm_plain(*a, 512) for a in cases]
    for _ in range(3):
        for a, y in zip(cases, want):
            assert torch.equal(muxq_gemm(*a, bk=512), y)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y_side = muxq_gemm(*cases[1], bk=512)
    side.synchronize()
    assert torch.equal(y_side, want[1])
    assert torch.equal(muxq_gemm(*cases[0], bk=512), want[0])


@pytest.mark.gpu
def test_cuda_muxq_gemm_refuses_an_n_major_weight(cuda):
    x, w, bs, sx, sw = _gemm_inputs(0, 4, 1024, 768, 512)
    args = [torch.from_numpy(a).to(cuda) for a in (x, w, bs, sx, sw)]
    with pytest.raises(ValueError, match="k-major"):
        muxq_gemm(*args, bk=512)


@pytest.mark.gpu
def test_cuda_served_weights_are_k_major(cuda):
    """``dispatch.buffer_to`` puts one k-major int8 copy of the weight on
    the card; the fused path runs through the kernel on it."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((896, 1152)).astype(np.float32)
    mask = np.zeros(896, bool)
    mask[[4, 500]] = True
    buf = {f: getattr(ops.prepare_weights(w, mask, 2), f).numpy()
           for f in dispatch.BUFFER_FIELDS}
    on_card = dispatch.buffer_to(buf, cuda)
    wi = on_card["w_int"]
    assert wi.T.is_contiguous() and wi.untyped_storage().nbytes() == wi.numel()
    assert torch.equal(wi.cpu(), torch.from_numpy(buf["w_int"]))
    x = torch.from_numpy(_outlier_x(rng, 4, 896, [4, 500])).to(cuda)
    before = G.LAUNCHES
    y = dispatch.fused_matmul(x, on_card)
    assert G.LAUNCHES == before + 1
    prev = dispatch.set_fused_impl("ref")
    try:
        assert torch.equal(y, dispatch.fused_matmul(x, on_card))
    finally:
        dispatch.set_fused_impl(prev)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 128])
def test_cuda_fused_emm_per_expert_bit_equal(cuda, cap):
    """A per-expert buffer packed on the card (``pack_site_buffer`` on a
    CUDA weight: the same bytes as on the host) runs ``fused_emm`` as one
    quantize and one GEMM per expert, bit-equal to the plain per-expert
    oracle form."""
    rng = np.random.default_rng(4)
    n_e, k, n = 4, 640, 384
    w = rng.standard_normal((n_e, k, n)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[[7, 300, 301]] = True
    from repro_torch.core.muxq import QuantConfig
    qcfg = QuantConfig(method="muxq", outlier_mode="static",
                       act_granularity="per_token", backend="fused",
                       weight_granularity="per_channel")
    host = dispatch.pack_site_buffer(torch.from_numpy(w), mask, qcfg, bk=128)
    card = dispatch.pack_site_buffer(torch.from_numpy(w).to(cuda), mask, qcfg,
                                     bk=128)
    for f in dispatch.BUFFER_FIELDS:
        np.testing.assert_array_equal(card[f], host[f], err_msg=f)
    buf = dispatch.buffer_to(card, cuda)
    x = torch.from_numpy(rng.standard_normal((n_e, cap, k)).astype(
        np.float32)).to(cuda)
    x[..., torch.from_numpy(mask).to(cuda)] *= 40.0
    before = (RQ.LAUNCHES, G.LAUNCHES)
    y = dispatch.fused_emm(x, buf)
    assert (RQ.LAUNCHES - before[0], G.LAUNCHES - before[1]) == (1, n_e)
    prev = dispatch.set_fused_impl("ref")
    try:
        assert torch.equal(y, dispatch.fused_emm(x, buf))
    finally:
        dispatch.set_fused_impl(prev)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
def test_cuda_paged_attention_matches_plain(cuda, mode, sq):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v, table, pos = _paged_inputs(sq, sq=sq)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    kw = {}
    if mode == "int8":
        parts = quantize_kv(t[1], t[2])
        t[1], t[2] = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
    ok = PA.paged_attention_decode(*t, **kw)
    op = PA.paged_attention_plain(*t, **kw)
    torch.testing.assert_close(ok, op, rtol=0, atol=1e-4)  # f32 sum order


@pytest.mark.gpu
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,g", [(1, 1), (4, 7), (32, 7)])
def test_cuda_paged_attention_int4_matches_plain(cuda, qdt, sq, g):
    """Int4 pages (packed nibbles, bf16 scales, a non-identity redist row):
    atol 1e-4 in f32 (sum order), 2e-2 with bf16 q (the plain version's
    bf16 einsums)."""
    q, k, v, table, pos = _paged_inputs(sq + g, sq=sq, h=2 * g)
    mask = np.zeros((2, 64), bool)
    mask[1, [3, 40]] = True
    redist = torch.from_numpy(redist_from_mask(mask)).to(cuda)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    parts = Int4KVQuantizer(redist, redist).quantize(t[1], t[2])
    kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"],
          "k_redist": redist, "v_redist": redist}
    args = (t[0].to(qdt), parts["k"], parts["v"], t[3], t[4])
    ok = PA.paged_attention_decode(*args, **kw)
    op = PA.paged_attention_plain(*args, **kw)
    assert torch.isfinite(ok).all()
    atol = 1e-4 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(ok.float(), op.float(), rtol=0, atol=atol)


@pytest.mark.gpu
def test_cuda_paged_attention_refuses_a_block_over_shared_memory(cuda):
    """sq 64 x h 16 over 2 KV heads (1024 query rows of dh 64) once needed
    more than the card's 227 KB of shared memory in one block.  A block now
    holds a 64-row tile, whatever sq * g is: the case runs and matches the
    plain version (atol 1e-4, f32 sum order).  The next launch, at decode,
    succeeds as well."""
    q, k, v, table, pos = _paged_inputs(0, sq=64, h=16, kvh=2)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    torch.testing.assert_close(PA.paged_attention_decode(*t),
                               PA.paged_attention_plain(*t), rtol=0, atol=1e-4)
    q, k, v, table, pos = _paged_inputs(0, sq=1, h=16, kvh=2)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    ok = PA.paged_attention_decode(*t)
    torch.testing.assert_close(ok, PA.paged_attention_plain(*t), rtol=0,
                               atol=1e-4)


def _long_table_inputs(seed, *, n_table, sq, b=4, h=14, kvh=2, dh=64, ps=16):
    """Slots on tables ``n_table`` pages wide: slot 0 at its table's end,
    slot 1 halfway, slot 2 in its first page, slot 3 idle on scratch page
    0."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_table + 1
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    table = (1 + rng.permutation(b * n_table)).reshape(b, n_table).astype(np.int32)
    table[3] = 0
    pos = np.array([n_table * ps - sq, n_table * ps // 2, 3, 0], np.int32)
    return q, k, v, table, pos


def _int4_pages(k, v, kvh, dh):
    mask = np.zeros((kvh, dh), bool)
    mask[kvh - 1, [3, dh // 2 + 3]] = True
    redist = torch.from_numpy(redist_from_mask(mask)).to(k.device)
    parts = Int4KVQuantizer(redist, redist).quantize(k, v)
    return parts["k"], parts["v"], {
        "k_scale": parts["k_scale"], "v_scale": parts["v_scale"],
        "k_redist": redist, "v_redist": redist}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp", "int8", "int4"])
@pytest.mark.parametrize("n_table,sq", [(64, 1), (64, 4), (13, 1), (13, 32)])
def test_cuda_paged_attention_splits_the_table(cuda, mode, n_table, sq):
    """Long tables (64 pages: several KV splits live, most of them empty for
    the short slots) and a width that is not a multiple of the split (13
    pages), qwen2's heads (g 7, a ragged 224-row tile at sq 32): f32 q at
    atol 1e-4 against the plain version, as every f32 case."""
    q, k, v, table, pos = _long_table_inputs(n_table + sq, n_table=n_table, sq=sq)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    _, pps, n_split = PA.plan_splits(4, 2, sq * 7, n_table, 16, 64,
                                     build.sm_count(t[0].device))
    assert n_split > 1
    kw = {}
    if mode == "int8":
        parts = quantize_kv(t[1], t[2])
        t[1], t[2] = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
    elif mode == "int4":
        t[1], t[2], kw = _int4_pages(t[1], t[2], 2, 64)
    ok = PA.paged_attention_decode(*t, **kw)
    assert torch.isfinite(ok).all()
    torch.testing.assert_close(ok, PA.paged_attention_plain(*t, **kw), rtol=0,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_qwen2_prefill_chunk(cuda, qdt):
    """A qwen2 prefill chunk on int4 pages: sq 32 x g 7 = 224 rows, three
    full row tiles of 64 and a ragged one of 32.  atol 1e-4 in f32; with
    bf16 q, 2e-2 as the int4 test above."""
    q, k, v, table, pos = _long_table_inputs(5, n_table=8, sq=32)
    pos[:] = [96, 64, 32, 0]
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    kp, vp, kw = _int4_pages(t[1], t[2], 2, 64)
    args = (t[0].to(qdt), kp, vp, t[3], t[4])
    ok = PA.paged_attention_decode(*args, **kw)
    assert torch.isfinite(ok).all()
    torch.testing.assert_close(ok.float(), PA.paged_attention_plain(*args, **kw).float(),
                               rtol=0, atol=1e-4 if qdt == torch.float32 else 2e-2)


@pytest.mark.gpu
def test_cuda_paged_attention_cell_prefill_chunk(cuda, monkeypatch):
    """qwen2.5-14b's prefill chunk in the benchmark's cell: 3 slots of sq
    512 at positions 0, 1536 and 3584 (the last ending at 4096 of a
    264-page table), 40 query heads over 8 KV heads of 128, int8 pages.
    The chunk tile runs it (2560 rows per (slot, KV head)); its output is
    within the f32 atol 1e-4 of the plain version and equal, bit for bit,
    to the row tile's on the same inputs."""
    b, sq, h, kvh, dh, ps, n_table = 3, 512, 40, 8, 128, 16, 264
    gen = torch.Generator(device=cuda).manual_seed(29)
    q = torch.randn(b, sq, h, dh, generator=gen, device=cuda)
    k = torch.randn(b * n_table + 1, ps, kvh, dh, generator=gen, device=cuda)
    v = torch.randn(b * n_table + 1, ps, kvh, dh, generator=gen, device=cuda)
    parts = quantize_kv(k, v)
    table = (1 + torch.randperm(b * n_table, generator=gen, device=cuda)).to(
        torch.int32).reshape(b, n_table)
    pos = torch.tensor([0, 1536, 3584], dtype=torch.int32, device=cuda)
    args = (q, parts["k"], parts["v"], table, pos)
    kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
    before = dict(PA.TILE_LAUNCHES)
    out = PA.paged_attention_decode(*args, **kw)
    assert PA.TILE_LAUNCHES["chunk"] == before["chunk"] + 1
    assert PA.TILE_LAUNCHES["row"] == before["row"]
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, PA.paged_attention_plain(*args, **kw), rtol=0,
                               atol=1e-4)
    monkeypatch.setattr(PA, "chunk_tile", lambda rows, dh, f32: False)
    rows_out = PA.paged_attention_decode(*args, **kw)
    assert PA.TILE_LAUNCHES["row"] == before["row"] + 1
    assert torch.equal(out, rows_out)


@pytest.mark.gpu
def test_cuda_paged_attention_tile_counter(cuda):
    """``TILE_LAUNCHES`` counts the chunk tile on an f32 prefill chunk
    (qwen2: sq 32 x g 7 = 224 rows) and the row tile on decode, on verify
    (sq 4 x g 7 = 28 rows), on a bf16 chunk and at dh 256."""
    q, k, v, table, pos = _long_table_inputs(5, n_table=8, sq=32)
    pos[:] = [96, 64, 32, 0]
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]

    def tiles(q_, k_, v_, tab, p_):
        before = dict(PA.TILE_LAUNCHES)
        PA.paged_attention_decode(q_, k_, v_, tab, p_)
        torch.cuda.synchronize()
        return tuple(PA.TILE_LAUNCHES[n] - before[n] for n in ("row", "chunk"))

    assert tiles(*t) == (0, 1)
    assert tiles(t[0][:, :4].contiguous(), *t[1:]) == (1, 0)
    assert tiles(t[0][:, 0].contiguous(), *t[1:]) == (1, 0)
    assert tiles(t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(), *t[3:]) == (1, 0)
    wide = torch.randn(4, 32, 14, 256, device=cuda)
    kw = torch.randn(k.shape[0], 16, 2, 256, device=cuda)
    assert tiles(wide, kw, kw.clone(), *t[3:]) == (1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=64, softcap=30.0)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, kw):
    """GQA 8 over 2 heads, ragged sq/sk (not multiples of the tile): atol
    2e-4, and in bf16 one bf16 ulp of the element on top (the plain version
    is f32 math rounded to bf16)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 200, 8, 64, generator=gen).to(cuda, dtype)
    k = torch.randn(2, 200, 2, 64, generator=gen).to(cuda, dtype)
    v = torch.randn(2, 200, 2, 64, generator=gen).to(cuda, dtype)
    ok = FA.flash_attention(q, k, v, **kw)
    op = FA.flash_attention_plain(q, k, v, **kw)
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert ok.dtype == dtype and torch.isfinite(ok).all()
    torch.testing.assert_close(ok.float(), op.float(), rtol=rtol, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,dh,kw", [
    (70, 130, 64, dict(causal=False)),
    (130, 70, 64, dict(causal=False, window=40)),
    (100, 100, 96, dict(causal=True)),
    (65, 65, 128, dict(causal=True, softcap=30.0)),
])
def test_cuda_flash_attention_ragged_tiles(cuda, dtype, sq, sk, dh, kw):
    """sq and sk not multiples of the 64-row query tile or of the key tile,
    sk != sq (non-causal), and head dims the tile pads (96 -> 128) or that
    take the 32-key tile (128).  Tolerances as above."""
    gen = torch.Generator().manual_seed(sq + sk + dh)
    q = torch.randn(2, sq, 6, dh, generator=gen).to(cuda, dtype)
    k = torch.randn(2, sk, 2, dh, generator=gen).to(cuda, dtype)
    v = torch.randn(2, sk, 2, dh, generator=gen).to(cuda, dtype)
    ok = FA.flash_attention(q, k, v, **kw)
    op = FA.flash_attention_plain(q, k, v, **kw)
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert ok.dtype == dtype and torch.isfinite(ok).all()
    torch.testing.assert_close(ok.float(), op.float(), rtol=rtol, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b", "whisper-tiny"])
def test_cuda_families_fused_serve_matches_plain(cuda, arch):
    """The SSM, hybrid and encoder-decoder families (reduced) served from
    a fused MUXQ artifact: prefill + 4 serve steps through the kernels
    give the plain versions' stream, with one quantize and one GEMM a
    site a step (the ragged N 40 of ``ssm_in_bcdt`` included)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import SitePolicy
    from repro_torch.launch.steps import (MUXQ_FUSED_SERVE, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import transformer as T
    from repro_torch.quantize import quantize_model

    cfg = get_config(arch, reduced=True)
    params = T.init_params(cfg, seed=0, device=cuda)
    hot = 19.0 if cfg.norm == "rmsnorm" else 20.0      # x20 either way
    for lp in params["layers"]:
        lp["ln1"]["gain"][[3, 17, 40]] = hot
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=g).to(cuda)}
    if cfg.is_enc_dec:
        batch["frames"] = torch.randn(2, cfg.n_audio_frames, cfg.d_model,
                                      generator=g).to(cuda)

    def forward(p, b, ctx):
        extra = {"frames": b["frames"]} if "frames" in b else None
        return T.forward(cfg, p, b["tokens"], ctx, extra=extra)
    art = quantize_model(cfg, params, [batch],
                         SitePolicy.uniform(MUXQ_FUSED_SERVE),
                         forward=forward, device=cuda)
    pre = make_prefill_step(cfg, 16, quant=art, kv_dtype=torch.float32,
                            device=cuda)
    serve = make_serve_step(cfg, quant=art, device=cuda)
    sites = sum(1 for s in art.kernel_buffers if not s.startswith("enc"))

    def stream(impl):
        prev = dispatch.set_fused_impl(impl)
        try:
            tok, cache = pre(params, batch)
            out = [tok]
            for _ in range(4):
                RQ.LAUNCHES = G.LAUNCHES = 0
                tok, cache = serve(params, {"tokens": tok[:, None],
                                            "cache": cache})
                out.append(tok)
                if impl == "auto":
                    torch.cuda.synchronize()
                    assert RQ.LAUNCHES == G.LAUNCHES == sites
        finally:
            dispatch.set_fused_impl(prev)
        return torch.stack(out, 1)
    assert torch.equal(stream("auto"), stream("ref"))
