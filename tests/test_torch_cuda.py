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

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
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


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 1024, 2304), (4, 3584, 768), (64, 1024, 3072)])
def test_cuda_muxq_gemm_matches_plain(cuda, m, k, n):
    x, w, bs, sx, sw = _gemm_inputs(m, m, k, n, 512)
    args = [torch.from_numpy(a) for a in (x, w, bs, sx, sw)]
    yk = muxq_gemm(*(a.to(cuda) for a in args), bk=512)
    yp = muxq_gemm(*args, bk=512)
    assert torch.equal(yk.cpu(), yp)


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
    """sq * g * dh above the card's 227 KB of shared memory: the launcher's
    opt-in fails and the wrapper raises; no launch is skipped silently.
    The failed opt-in leaves no stale error: the next launch succeeds."""
    q, k, v, table, pos = _paged_inputs(0, sq=64, h=16, kvh=2)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    with pytest.raises(RuntimeError, match="cudaError"):
        PA.paged_attention_decode(*t)
    q, k, v, table, pos = _paged_inputs(0, sq=1, h=16, kvh=2)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, table, pos)]
    ok = PA.paged_attention_decode(*t)
    torch.testing.assert_close(ok, PA.paged_attention_plain(*t), rtol=0,
                               atol=1e-4)


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
