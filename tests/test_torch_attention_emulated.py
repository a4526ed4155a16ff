"""The CUDA source of the two attention kernels, run on the CPU through
the host emulation in ``tools/cuda_emulator`` and held against the plain
versions at the tolerances of the GPU tests (``tests/test_torch_cuda.py``):
atol 1e-4 for f32 paged attention and 2e-4 for f32 flash; bf16 within one
bf16 ulp of the f32 twin (paged) or of the plain version (flash).  The
emulation checks indexing, fragment layouts, masks and the split schedule;
the card checks the rest.  Skips where there is no host C++ compiler."""
import ctypes
import ctypes.util
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.serve.kvcache import quantize_kv
from repro_torch.serve.kvq import Int4KVQuantizer, redist_from_mask, unpack_int4

REPO = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def emulated():
    if not any(shutil.which(c) for c in ("g++", "c++", "clang++")):
        pytest.skip("needs a host C++ compiler to emulate the CUDA kernels")
    spec = importlib.util.spec_from_file_location(
        "cuda_emulator", REPO / "tools" / "cuda_emulator" / "emulate.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    with emu.patch():
        yield


def _pages(seed, *, b, sq, h, kvh, n_table, dh=64, ps=16):
    """Slot 0 at its table's end, slot 1 halfway, slot 2 idle on scratch
    page 0 (pos 0)."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_table + 1
    q = torch.from_numpy(rng.standard_normal((b, sq, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32))
    table = torch.from_numpy(
        (1 + rng.permutation(b * n_table)).reshape(b, n_table).astype(np.int32))
    table[-1] = 0
    pos = torch.tensor([n_table * ps - sq, n_table * ps // 2] + [0] * (b - 2),
                       dtype=torch.int32)
    return q, k, v, table, pos


def _mode(mode, k, v):
    if mode == "int8":
        parts = quantize_kv(k, v)
        return parts["k"], parts["v"], {"k_scale": parts["k_scale"],
                                        "v_scale": parts["v_scale"]}
    if mode == "int4":
        kvh, dh = k.shape[2], k.shape[3]
        mask = np.zeros((kvh, dh), bool)
        mask[kvh - 1, [3, dh // 2 + 3]] = True
        redist = torch.from_numpy(redist_from_mask(mask))
        parts = Int4KVQuantizer(redist, redist).quantize(k, v)
        return parts["k"], parts["v"], {
            "k_scale": parts["k_scale"], "v_scale": parts["v_scale"],
            "k_redist": redist, "v_redist": redist}
    return k, v, {}


def _run_paged(q, k, v, table, pos, kw):
    return PA._launch(q, k, v, table, pos, kw.get("k_scale"), kw.get("v_scale"),
                      kw.get("k_redist"), kw.get("v_redist"), kw.get("window"),
                      kw.get("softcap"), kw.get("plan_kv_heads"))


def _f32_twin(q, k, v, table, pos, kw):
    """The plain version in f32 on the kernel's operands for bf16 q: pages
    dequantized in the plain version's order and rounded to bf16."""
    if "k_redist" in kw:
        kd, vd = ((unpack_int4(x).float() * kw[f"{n}_scale"].float()
                   * kw[f"{n}_redist"]) for x, n in ((k, "k"), (v, "v")))
    elif "k_scale" in kw:
        kd, vd = k.float() * kw["k_scale"], v.float() * kw["v_scale"]
    else:
        kd, vd = k.float(), v.float()
    kd, vd = (x.to(q.dtype).float() for x in (kd, vd))
    extra = {n: kw[n] for n in ("window", "softcap") if n in kw}
    return PA.paged_attention_plain(q.float(), kd, vd, table, pos,
                                    **extra).to(q.dtype)


@pytest.mark.parametrize("mode,n_table,sq,g,qdt", [
    ("fp", 4, 1, 1, torch.float32),
    ("int8", 4, 4, 1, torch.float32),
    ("int4", 8, 4, 7, torch.float32),
    ("int4", 8, 32, 7, torch.float32),
    ("int4", 8, 32, 7, torch.bfloat16),
    ("fp", 64, 1, 7, torch.float32),
    ("int8", 13, 4, 7, torch.float32),
    ("fp", 13, 1, 7, torch.bfloat16),
])
def test_emulated_paged_attention_matches_plain(emulated, mode, n_table, sq, g,
                                                qdt):
    """Ragged tables with scratch page 0, several KV splits (64 and 13
    pages), qwen2's 224-row prefill tile, all three page modes."""
    q, k, v, table, pos = _pages(n_table + sq + g, b=3, sq=sq, h=2 * g, kvh=2,
                                 n_table=n_table)
    k, v, kw = _mode(mode, k, v)
    args = (q.to(qdt), k.to(qdt) if mode == "fp" else k,
            v.to(qdt) if mode == "fp" else v, table, pos)
    out = _run_paged(*args, kw)
    assert out.dtype == qdt and torch.isfinite(out).all()
    if qdt == torch.float32:
        torch.testing.assert_close(out, PA.paged_attention_plain(*args, **kw),
                                   rtol=0, atol=1e-4)
    else:
        twin = _f32_twin(*args, kw).float()
        assert bool(((out.float() - twin).abs()
                     <= 1e-4 + BF16_ULP * twin.abs()).all())


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_emulated_paged_attention_window_and_softcap(emulated, qdt):
    q, k, v, table, pos = _pages(5, b=3, sq=4, h=4, kvh=2, n_table=6)
    kw = {"window": 20, "softcap": 30.0}
    args = (q.to(qdt), k.to(qdt), v.to(qdt), table, pos)
    out = _run_paged(*args, kw)
    if qdt == torch.float32:
        torch.testing.assert_close(out, PA.paged_attention_plain(*args, **kw),
                                   rtol=0, atol=1e-4)
    else:
        twin = _f32_twin(*args, kw).float()
        assert bool(((out.float() - twin).abs()
                     <= 1e-4 + BF16_ULP * twin.abs()).all())


def test_emulated_paged_attention_wide_query_block(emulated):
    """sq 64 x 16 heads over 2 KV heads: 512 query rows per (slot, KV head)
    in 8 row tiles, the case whose shared memory once grew past the card's
    limit."""
    q, k, v, table, pos = _pages(6, b=2, sq=64, h=16, kvh=2, n_table=5)
    out = _run_paged(q, k, v, table, pos, {})
    torch.testing.assert_close(out, PA.paged_attention_plain(q, k, v, table, pos),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("tp", [2, 4])
def test_emulated_paged_attention_head_shards_at_the_global_plan(emulated, tp):
    """Tensor-parallel serving runs the kernel on each rank's kvh / tp
    heads (contiguous pages, its slice of the redistribution rows) with
    the split plan of all kvh heads: the ranks' outputs, concatenated over
    heads, are bit-equal to one launch over every head, on int4 pages with
    several KV splits."""
    kvh, g = 4, 2
    q, k, v, table, pos = _pages(40 + tp, b=3, sq=1, h=kvh * g, kvh=kvh,
                                 n_table=13)
    k, v, kw = _mode("int4", k, v)
    full = _run_paged(q, k, v, table, pos, kw)
    kl, hl = kvh // tp, kvh // tp * g
    parts = []
    for r in range(tp):
        heads = slice(r * kl, (r + 1) * kl)
        rkw = {n: (t[heads] if n.endswith("redist") else t[:, :, heads])
               .contiguous() for n, t in kw.items()}
        parts.append(_run_paged(
            q[:, :, r * hl:(r + 1) * hl], k[:, :, heads].contiguous(),
            v[:, :, heads].contiguous(), table, pos,
            {**rkw, "plan_kv_heads": kvh}))
    assert torch.equal(torch.cat(parts, dim=2), full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,dh,kw", [
    (200, 200, 64, dict(causal=True)),
    (70, 130, 64, dict(causal=False)),
    (130, 70, 64, dict(causal=False, window=40)),
    (50, 50, 96, dict(causal=True, window=16, softcap=30.0)),
])
def test_emulated_flash_attention_matches_plain(emulated, dtype, sq, sk, dh,
                                                kw):
    """Paired causal query tiles, ragged sq and sk, sk != sq, rows with no
    key at all (window 40, sq > sk: they average V over every key, as the
    plain version does), a padded head dim.  atol 2e-4, plus one bf16 ulp
    of the element in bf16."""
    gen = torch.Generator().manual_seed(sq + sk + dh)
    q = torch.randn(1, sq, 4, dh, generator=gen).to(dtype)
    k = torch.randn(1, sk, 2, dh, generator=gen).to(dtype)
    v = torch.randn(1, sk, 2, dh, generator=gen).to(dtype)
    out = FA._launch(q, k, v, kw["causal"], kw.get("window"), kw.get("softcap"))
    ref = FA.flash_attention_plain(q, k, v, **kw)
    rtol = 0.0 if dtype == torch.float32 else BF16_ULP
    assert out.dtype == dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=2e-4)


def _gpu_plain_order(q, k, v, pos, scale):
    """Paged attention of fp pages as the plain version computes it on the
    card (with its tables in order): each score one fmaf chain over the
    channels from 0; PyTorch's warp softmax (max; exp(x - max); lane l of
    32 sums keys l, l + 32, ... in order, then an xor butterfly over the
    lanes; exp / sum); P.V one fmaf chain over the keys from 0.  fmaf and
    expf are the C library's, as in the emulated kernel.  q [rows, dh] f32
    at positions ``pos``; k, v [keys, dh] f32."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.fmaf.argtypes = [ctypes.c_float] * 3
    libm.fmaf.restype = ctypes.c_float
    libm.expf.argtypes = [ctypes.c_float]
    libm.expf.restype = ctypes.c_float
    f32 = np.float32
    n, dh = k.shape
    out = np.zeros((q.shape[0], dh), np.float32)
    for r in range(q.shape[0]):
        s = np.empty(n, np.float32)
        for key in range(n):
            acc = 0.0
            for d in range(dh):
                acc = libm.fmaf(float(q[r, d]), float(k[key, d]), acc)
            s[key] = f32(acc) * f32(scale) if key <= pos[r] else f32(-1e9)
        e = np.array([libm.expf(float(f32(x - s.max()))) for x in s], np.float32)
        lanes = [f32(0.0) for _ in range(32)]
        for key in range(n):                       # lane key % 32, in order
            lanes[key % 32] = f32(lanes[key % 32] + e[key])
        for off in (16, 8, 4, 2, 1):
            lanes = [f32(lanes[i] + lanes[i ^ off]) for i in range(32)]
        probs = e / lanes[0]
        for d in range(dh):
            acc = 0.0
            for key in range(n):
                acc = libm.fmaf(float(probs[key]), float(v[key, d]), acc)
            out[r, d] = acc
    return out


@pytest.mark.parametrize("n_table", [1, 2, 4])
def test_emulated_single_tile_is_the_plain_arithmetic(emulated, n_table):
    """A table of at most one key tile is not split, and the f32 kernel then
    normalizes before P.V in the plain version's order: its output equals,
    bit for bit, the plain version's operations as the card runs them
    (tables of 16, 32 and 64 keys; key 63 masked for the first row)."""
    rng = np.random.default_rng(n_table)
    ps, dh, n_keys = 16, 64, 16 * n_table
    q = (rng.standard_normal((1, 2, 2, dh)) * 3).astype(np.float32)
    k = (rng.standard_normal((n_table + 1, ps, 1, dh)) * 3).astype(np.float32)
    v = (rng.standard_normal((n_table + 1, ps, 1, dh)) * 3).astype(np.float32)
    table = np.arange(1, n_table + 1, dtype=np.int32)[None]
    pos = np.array([n_keys - 2], np.int32)
    out = _run_paged(*(torch.from_numpy(a) for a in (q, k, v, table, pos)), {})
    kk = k[1:].reshape(n_keys, dh)
    vv = v[1:].reshape(n_keys, dh)
    rows = q[0].transpose(1, 0, 2).reshape(-1, dh)       # (head, token) rows
    qpos = np.tile(pos[0] + np.arange(2), 2)
    want = _gpu_plain_order(rows, kk, vv, qpos, dh ** -0.5)
    got = out[0].permute(1, 0, 2).reshape(-1, dh).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture
def row_tile_only(monkeypatch):
    """Run ``fn`` with every launch on the row tile, as before the chunk
    tile: the reference the chunk tile is held to."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(PA, "chunk_tile", lambda rows, dh, f32: False)
            return fn()
    return run


@pytest.fixture
def sms(monkeypatch):
    """Set the emulated card's SM count, which the split plan fills."""
    from repro_torch.kernels import build as kbuild
    return lambda n: monkeypatch.setattr(kbuild, "sm_count", lambda device: n)


@pytest.mark.parametrize("mode,dh,g,sq,n_table,n_sm", [
    ("fp", 64, 1, 65, 6, 4),
    ("int8", 128, 5, 65, 6, 4),
    ("int4", 64, 7, 65, 6, 4),
    ("int4", 128, 5, 65, 6, 64),
])
def test_emulated_chunk_tile_is_the_row_tiles_arithmetic(emulated, row_tile_only, sms,
                                                         mode, dh, g, sq, n_table,
                                                         n_sm):
    """f32 q with more than 64 rows per (slot, KV head) runs the chunk
    tile: slots whose chunk ends at the table's end, starts halfway
    (and runs past the table), starts at position 0, and an idle slot on
    scratch page 0; ragged last row tiles (65 g rows); whole tables (4 SMs)
    and split ones (64 SMs: 3 splits).  Its output equals the row tile's
    bit for bit, and the plain version's within the f32 atol 1e-4."""
    sms(n_sm)
    q, k, v, table, pos = _pages(n_table + sq + g + dh, b=4, sq=sq, h=g, kvh=1,
                                 n_table=n_table, dh=dh)
    k, v, kw = _mode(mode, k, v)
    args = (q, k, v, table, pos)
    before = PA.TILE_LAUNCHES["chunk"]
    out = _run_paged(*args, kw)
    assert PA.TILE_LAUNCHES["chunk"] == before + 1
    assert torch.isfinite(out).all()
    assert torch.equal(out, row_tile_only(lambda: _run_paged(*args, kw)))
    torch.testing.assert_close(out, PA.paged_attention_plain(*args, **kw),
                               rtol=0, atol=1e-4)


def test_emulated_chunk_tile_full_chunk_matches_plain(emulated, sms):
    """A chunk of 512 (8 row tiles, the cell's chunk length) on int8
    pages at dh 64: the chunk ending at the table's end from position 0,
    one from halfway past the end, and the idle slot; within the f32 atol
    1e-4 of the plain version."""
    sms(4)
    q, k, v, table, pos = _pages(512, b=3, sq=512, h=1, kvh=1, n_table=32)
    k, v, kw = _mode("int8", k, v)
    before = PA.TILE_LAUNCHES["chunk"]
    out = _run_paged(q, k, v, table, pos, kw)
    assert PA.TILE_LAUNCHES["chunk"] == before + 1
    torch.testing.assert_close(out, PA.paged_attention_plain(q, k, v, table, pos, **kw),
                               rtol=0, atol=1e-4)


def test_emulated_chunk_tile_window_and_softcap(emulated, row_tile_only, sms):
    """A window of 20 with a softcap of 30 under the chunk tile (dh 128, g
    5): bit-equal to the row tile, within 1e-4 of the plain version."""
    sms(4)
    q, k, v, table, pos = _pages(133, b=4, sq=65, h=5, kvh=1, n_table=6, dh=128)
    kw = {"window": 20, "softcap": 30.0}
    out = _run_paged(q, k, v, table, pos, kw)
    assert torch.equal(out, row_tile_only(lambda: _run_paged(q, k, v, table, pos, kw)))
    torch.testing.assert_close(out, PA.paged_attention_plain(q, k, v, table, pos, **kw),
                               rtol=0, atol=1e-4)


def test_emulated_chunk_tile_single_tile_is_the_plain_arithmetic(emulated):
    """A table of one key tile (4 pages of 16 at dh 64) under 65 query rows
    (sq 13 x g 5): the chunk tile normalizes before P.V in PyTorch's order,
    and its output equals, bit for bit, the plain version's operations as
    the card runs them (key 63 masked for every row)."""
    rng = np.random.default_rng(65)
    ps, dh, n_table, sq, g = 16, 64, 4, 13, 5
    n_keys = ps * n_table
    q = (rng.standard_normal((1, sq, g, dh)) * 3).astype(np.float32)
    k = (rng.standard_normal((n_table + 1, ps, 1, dh)) * 3).astype(np.float32)
    v = (rng.standard_normal((n_table + 1, ps, 1, dh)) * 3).astype(np.float32)
    table = np.arange(1, n_table + 1, dtype=np.int32)[None]
    pos = np.array([n_keys - sq - 1], np.int32)
    before = PA.TILE_LAUNCHES["chunk"]
    out = _run_paged(*(torch.from_numpy(a) for a in (q, k, v, table, pos)), {})
    assert PA.TILE_LAUNCHES["chunk"] == before + 1
    rows = q[0].transpose(1, 0, 2).reshape(-1, dh)       # (head, token) rows
    qpos = np.tile(pos[0] + np.arange(sq), g)
    want = _gpu_plain_order(rows, k[1:].reshape(n_keys, dh), v[1:].reshape(n_keys, dh),
                            qpos, dh ** -0.5)
    got = out[0].permute(1, 0, 2).reshape(-1, dh).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_emulated_chunk_tile_head_shards_at_the_global_plan(emulated, sms):
    """A rank of a tp-2 serve runs its chunk (sq 65 x g 2 = 130 rows on int8
    pages, 6 pages in 2 splits) on its kvh / tp heads with the plan of all
    kvh heads: the ranks' outputs, concatenated over heads, are bit-equal
    to one launch over every head."""
    kvh, g, tp = 4, 2, 2
    sms(32)
    assert PA.plan_splits(2, kvh, 65 * g, 6, 16, 64, 32)[2] == 2
    q, k, v, table, pos = _pages(52, b=2, sq=65, h=kvh * g, kvh=kvh, n_table=6)
    k, v, kw = _mode("int8", k, v)
    full = _run_paged(q, k, v, table, pos, kw)
    kl, hl = kvh // tp, kvh // tp * g
    parts = []
    for r in range(tp):
        heads = slice(r * kl, (r + 1) * kl)
        rkw = {n: t[:, :, heads].contiguous() for n, t in kw.items()}
        parts.append(_run_paged(
            q[:, :, r * hl:(r + 1) * hl], k[:, :, heads].contiguous(),
            v[:, :, heads].contiguous(), table, pos,
            {**rkw, "plan_kv_heads": kvh}))
    assert torch.equal(torch.cat(parts, dim=2), full)
