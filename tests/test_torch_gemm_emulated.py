"""The CUDA source of ``muxq_gemm`` and ``rowwise_quantize``, run on the CPU
through the host emulation in ``tools/cuda_emulator`` and held bit-equal
to the plain versions (``torch.equal``), as the GPU tests hold the card's
kernels (``tests/test_torch_cuda.py``).  The emulated int8 MMA sums
exactly, and a cluster's blocks run at once (their split-K sums meet in
distributed shared memory), so the GEMM's result may not depend on the
order in which clusters run: forward, reversed and shuffled.  Skips where
there is no host C++ compiler."""
import ctypes
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import muxq_gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as RQ

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def emu():
    if not any(shutil.which(c) for c in ("g++", "c++", "clang++")):
        pytest.skip("needs a host C++ compiler to emulate the CUDA kernels")
    spec = importlib.util.spec_from_file_location(
        "cuda_emulator", REPO / "tools" / "cuda_emulator" / "emulate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def _gemm(seed, m, k, n, bk=512, e=3):
    """Full-range int8 codes, a 2^e first K-block (the outlier run), the
    weight k-major as the served copy is."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    bs = torch.ones(k // bk, dtype=torch.int32)
    bs[0] = 2 ** e
    sx = torch.from_numpy(rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.01, 0.1, (1, n)).astype(np.float32))
    return x, w.T.contiguous().T, bs, sx, sw


def _plan(emu, m, n, k, n_sm=132):
    """The kernel's own grid plan (its C entry's ``muxq_gemm_plan``):
    (token rows a block, K tiles a stage, K tiles a split, splits)."""
    fn = ctypes.CDLL(str(emu.build()["muxq_gemm"])).muxq_gemm_plan
    out = (ctypes.c_int * 4)()
    assert fn(m, n, k, n_sm, out) == 0
    return tuple(out)


def _held(x, w, bs, sx, sw, bk=512):
    y = G._launch(x, w, bs, sx, sw, bk)
    assert torch.equal(y, G.muxq_gemm_plain(x, w, bs, sx, sw, bk))
    return y


@pytest.mark.parametrize("m,k,n", [
    (1, 1024, 768),      # one n8 tile, 16 K tiles split 8 ways
    (4, 1536, 1152),     # decode on qwen2's attn_qkv width
    (4, 5632, 200),      # qwen2 mlp_down's K_pad, ragged N
    (20, 1536, 776),     # verify rows (3 n8 tiles), ragged N
    (64, 1024, 768),     # prefill rows: one block of 64 rows
    (130, 1024, 136),    # 3 row blocks, the last holding 2 rows; one split
])
def test_emulated_muxq_gemm_bit_equal(emu, m, k, n):
    rows, stage, split_tiles, n_splits = _plan(emu, m, n, k)
    assert split_tiles * n_splits >= k // 64 > split_tiles * (n_splits - 1)
    assert split_tiles % stage == 0 and rows == min(64, -(-m // 8) * 8)
    with emu.patch():
        _held(*_gemm(m + k + n, m, k, n))


@pytest.mark.parametrize("m", [1, 4, 20, 64, 128, 130])
@pytest.mark.parametrize("k,n", [(1536, 768), (1536, 2304), (1536, 3072),
                                 (3584, 768), (1536, 1152), (1536, 896),
                                 (1536, 9728), (5632, 896)])
def test_muxq_gemm_plan_covers_the_card(emu, m, k, n):
    """The C entry's plan (``muxq_gemm_plan``): blocks of up to 64 token
    rows; every split holds whole pipeline stages (4 K tiles at decode M,
    2 above) and the splits cover K; a tile's splits fit one cluster (at
    most 8 blocks); the grid reaches one block a SM of a 132-SM card unless
    the splits are as many as whole stages allow."""
    k_tiles = k // 64
    rows, sub, split_tiles, n_splits = _plan(emu, m, n, k)
    assert rows == min(64, -(-m // 8) * 8)
    assert sub == (4 if m <= 8 else 2)
    assert split_tiles % sub == 0
    assert (n_splits - 1) * split_tiles < k_tiles <= n_splits * split_tiles
    assert 1 <= n_splits <= 8
    blocks = -(-n // 64) * -(-m // rows) * n_splits
    units = -(-k_tiles // sub)
    assert blocks >= 132 or split_tiles == sub * -(-units // min(8, units))


@pytest.mark.parametrize("order", ["reverse", "shuffle:1", "shuffle:2"])
@pytest.mark.parametrize("m,k,n", [(4, 1536, 776), (20, 5632, 72)])
def test_emulated_muxq_gemm_any_cluster_order(emu, order, m, k, n):
    """The clusters of split blocks, in any order: the same integer sums."""
    assert _plan(emu, m, n, k)[3] > 1
    with emu.patch(block_order=order):
        _held(*_gemm(7, m, k, n))


def test_emulated_muxq_gemm_splits_cross_k_blocks(emu):
    """K-blocks of 128 (two K tiles) and splits of more: a split's range
    (and a pipeline stage) crosses blocks, and each block's partial sum
    takes its own scale (2^3 on the first, 1 after)."""
    x, w, bs, sx, sw = _gemm(3, 48, 1536, 72, bk=128)
    assert _plan(emu, 48, 72, 1536)[2] > 2
    with emu.patch(block_order="shuffle:5"):
        _held(x, w, bs, sx, sw, bk=128)


@pytest.mark.parametrize("m,k", [(4, 1088), (20, 1472), (64, 1472)])
def test_emulated_muxq_gemm_ragged_last_stage(emu, m, k):
    """K tiles that no stage size divides (17 and 23 tiles of 64, K-blocks
    of 64): the last stage of a split holds fewer tiles than the others,
    loads only those and scales each block in."""
    rows, stage, split_tiles, n_splits = _plan(emu, m, 72, k)
    assert (k // 64) % stage and (k // 64) % split_tiles
    with emu.patch(block_order="shuffle:4"):
        _held(*_gemm(m + k, m, k, 72, bk=64, e=2), bk=64)


def test_emulated_muxq_gemm_back_to_back_shapes(emu):
    """Calls of other shapes and split counts back to back: each launch
    finishes its own tiles and leaves nothing for the next."""
    cases = [_gemm(s, m, k, n) for s, (m, k, n) in
             enumerate([(4, 1536, 776), (20, 1024, 200), (1, 5632, 136),
                        (130, 512, 72), (4, 1536, 776)])]
    assert len({_plan(emu, c[0].shape[0], c[1].shape[1], c[1].shape[0])
                for c in cases}) > 2
    with emu.patch(block_order="reverse"):
        for case in cases:
            _held(*case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(1, 768), (4, 896), (3, 4864), (2, 9000)])
def test_emulated_rowwise_quantize_bit_equal(emu, dtype, m, k):
    """The fused body at gpt2's and qwen2's widths and at one wider than a
    block holds in registers (K_pad 9728 > 512 threads x 16 values: the
    rest is gathered twice); then the scalar paths: unfused, and fused with
    a gather width that is not a multiple of 4."""
    rng = np.random.default_rng(k + m)
    w = rng.standard_normal((k, 4)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[rng.choice(k, 8, replace=False)] = True
    mw = ops.prepare_weights(w, mask, 3, bk=512)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, mask] *= 40.0
    x = torch.from_numpy(x).to(dtype)
    g3, s3 = mw.gather_idx[3:].contiguous(), mw.in_scale[3:].contiguous()
    with emu.patch():
        qk, sk = RQ._launch(x, 8, mw.gather_idx, mw.in_scale)
        qu, su = RQ._launch(x[:, : k - 3], 8, None, None)
        q3, s3k = RQ._launch(x, 8, g3, s3)      # fused, unstaged: K_pad - 3 codes
    qp, sp = RQ.rowwise_quantize_plain(x, 8, mw.gather_idx, mw.in_scale)
    assert torch.equal(qk, qp) and torch.equal(sk, sp)
    qp, sp = RQ.rowwise_quantize_plain(x[:, : k - 3], 8)
    assert torch.equal(qu, qp) and torch.equal(su, sp)
    qp, sp = RQ.rowwise_quantize_plain(x, 8, g3, s3)
    assert torch.equal(q3, qp) and torch.equal(s3k, sp)
