"""The schedule and the arithmetic of the tensor-core attention kernels
(``csrc/attention_common.cuh``, ``csrc/paged_attention.cu``), checked on
the CPU where the kernels cannot run.

- ``paged_attention.plan_splits``, the wrapper's choice of row tiles and KV
  splits: every (slot, KV head, query row, page) falls in exactly one
  block, no split is empty, and decode fills the card.
- A torch emulation of the kernel's schedule (row tiles, KV splits, key
  tiles, online softmax, empty partials, the merge) against
  ``paged_attention_plain`` and the reference's ``paged_attention_ref``,
  with empty splits, an idle slot on scratch page 0, rows whose every key
  is masked and a sliding window.
- Tensor cores for f32: emulated at the shapes of the GPU test
  ``test_cuda_paged_attention_matches_plain``, a single TF32 product misses
  that test's atol 1e-4 and 3xTF32 meets it.  (On the card 3xTF32 still
  sat twice as far from the plain version as FMA chains do, so the f32
  kernels multiply on the CUDA cores; ``PERF.md``.)

Inputs are seeded numpy arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_ref as jpaged_ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.serve.kvcache import quantize_kv

KEY_TILE = 64       # key_tile<64>() of csrc/attention_common.cuh (dh <= 64)


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

def _blocks(b, kvh, rows, n_table, ps, dh, n_sm):
    """(slot, head, row range, page range) of every block of the grid."""
    n_rt, pps, n_split = PA.plan_splits(b, kvh, rows, n_table, ps, dh, n_sm)
    for bi in range(b):
        for hh in range(kvh):
            for rt in range(n_rt):
                for sp in range(n_split):
                    yield (bi, hh, range(rt * PA.ROW_TILE,
                                         min(rows, (rt + 1) * PA.ROW_TILE)),
                           range(sp * pps, min(n_table, (sp + 1) * pps)))


@pytest.mark.parametrize("sq", [1, 4, 32])
@pytest.mark.parametrize("g", [1, 7])
def test_plan_covers_every_row_and_page_once(sq, g):
    for b, kvh, n_sm in ((4, 2, 132), (1, 1, 132), (3, 12, 132), (4, 2, 8)):
        rows = sq * g
        for ps, dh in ((16, 64), (4, 64), (16, 128), (8, 256)):
            for n_table in range(1, 17):
                seen = np.zeros((b, kvh, rows, n_table), np.int64)
                for bi, hh, rr, pr in _blocks(b, kvh, rows, n_table, ps, dh, n_sm):
                    assert len(rr) > 0 and len(pr) > 0, "an empty row tile or split"
                    for r in rr:
                        seen[bi, hh, r, pr.start:pr.stop] += 1
                assert (seen == 1).all(), (b, kvh, rows, n_table, ps, dh, n_sm)


def test_plan_fills_the_card_at_decode():
    """qwen2 decode (4 slots x 2 KV heads, pages of 16, dh 64): one page a
    split, so 64 blocks on an 8-page table and 128 on 16 pages, where one
    block per (slot, head) gave 8; gpt2 (12 heads) needs 3 splits for a
    full wave; a prefill chunk of 224 rows has 4 row tiles.  A table of at
    most one key tile (64 keys at dh 64, 32 at dh 128) is not split."""
    assert PA.plan_splits(4, 2, 7, 8, 16, 64) == (1, 1, 8)
    assert PA.plan_splits(4, 2, 7, 16, 16, 64) == (1, 1, 16)
    assert PA.plan_splits(4, 12, 1, 8, 16, 64) == (1, 3, 3)
    assert PA.plan_splits(4, 2, 224, 8, 16, 64) == (4, 2, 4)
    assert PA.plan_splits(1, 1, 1, 1 << 16, 16, 64, n_sm=1) == (
        1, PA.MAX_PAGES_PER_SPLIT, (1 << 16) // PA.MAX_PAGES_PER_SPLIT)
    assert PA.plan_splits(2, 2, 7, 0, 16, 64) == (1, 1, 1)
    assert PA.plan_splits(2, 2, 28, 4, 16, 64) == (1, 4, 1)
    assert PA.plan_splits(4, 2, 7, 2, 16, 128) == (1, 2, 1)
    assert PA.plan_splits(4, 2, 7, 4, 16, 128) == (1, 1, 4)
    assert [PA.key_tile(dh) for dh in (8, 64, 96, 128, 256)] == [64, 64, 32, 32, 16]
    # partials: O, m and l per split and padded row
    assert PA.workspace_floats(4, 2, 7, 64, 1, 8) == 8 * 4 * 2 * 64 * 66
    assert PA.workspace_floats(4, 2, 7, 64, 1, 1) == 0


# ---------------------------------------------------------------------------
# Split-KV partials and their merge
# ---------------------------------------------------------------------------

def split_kv_emulation(q, k, v, table, pos, *, window=None, softcap=None,
                       n_sm=132):
    """The paged kernel's schedule in f32 torch on fp pages: row tiles and
    KV splits from ``plan_splits``; a block reads pages up to its row
    tile's last position and walks its split in key tiles of KEY_TILE
    positions with an online softmax (m from NEG_INF, masked scores
    NEG_INF); an empty split is the partial (m = -inf, l = 0); the merge
    weighs the non-empty ones by exp(m - max m)."""
    b, sq, h, dh = q.shape
    ps, kvh = k.shape[1], k.shape[2]
    g, n_table = h // kvh, table.shape[1]
    rows = sq * g
    n_rt, pps, n_split = PA.plan_splits(b, kvh, rows, n_table, ps, dh, n_sm)
    win = PA.NO_WINDOW if window is None else window
    out = torch.empty_like(q)
    for bi in range(b):
        for hh in range(kvh):
            for rt in range(n_rt):
                r = torch.arange(rt * PA.ROW_TILE, min(rows, (rt + 1) * PA.ROW_TILE))
                qi, head = r // g, hh * g + r % g
                qr, qpos = q[bi, qi, head], int(pos[bi]) + qi
                n_read = min(n_table, int(qpos[-1]) // ps + 1)
                parts = []
                for sp in range(n_split):
                    j0, j1 = sp * pps, min(sp * pps + pps, n_read)
                    if j0 >= j1:
                        parts.append(None)          # m = -inf, l = 0
                        continue
                    m = torch.full((len(r),), PA.NEG_INF)
                    l = torch.zeros(len(r))
                    o = torch.zeros(len(r), dh)
                    for t0 in range(j0 * ps, j1 * ps, KEY_TILE):
                        kp = torch.arange(t0, min(t0 + KEY_TILE, j1 * ps))
                        pid = table[bi, kp // ps].long()
                        kt, vt = k[pid, kp % ps, hh], v[pid, kp % ps, hh]
                        s = (qr @ kt.T) * dh ** -0.5
                        if softcap is not None:
                            s = softcap * torch.tanh(s / softcap)
                        allow = (kp[None] <= qpos[:, None]) & (kp[None] > qpos[:, None] - win)
                        s = torch.where(allow, s, torch.tensor(PA.NEG_INF))
                        m_new = torch.maximum(m, s.max(-1).values)
                        p = torch.exp(s - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + p @ vt
                        m = m_new
                    parts.append((m, l, o))
                live = [x for x in parts if x is not None]
                mx = torch.stack([x[0] for x in live]).max(0).values
                w = [torch.exp(x[0] - mx) for x in live]
                lsum = sum(wi * x[1] for wi, x in zip(w, live))
                osum = sum(wi[:, None] * x[2] for wi, x in zip(w, live))
                out[bi, qi, head] = osum / lsum.clamp_min(1e-30)[:, None]
    return out


def _split_inputs(seed, sq, g, *, ps=8, dh=16, n_table=12):
    """3 slots over 2 KV heads: slot 0's table full, slot 1's short (its
    tail on scratch page 0), slot 2 idle (every entry scratch page 0, pos
    0)."""
    rng = np.random.default_rng(seed)
    b, kvh = 3, 2
    n_pages = 2 * n_table
    q = rng.standard_normal((b, sq, kvh * g, dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kvh, dh)).astype(np.float32)
    table = np.zeros((b, n_table), np.int32)
    table[0] = np.arange(1, 1 + n_table)
    table[1, :3] = [n_table + 1, n_table + 2, n_table + 3]
    pos = np.array([n_table * ps - sq, 9, 0], np.int32)
    return q, k, v, table, pos


@pytest.mark.parametrize("sq,g", [(1, 1), (1, 7), (4, 7), (32, 1), (32, 7)])
@pytest.mark.parametrize("n_sm", [132, 4])
def test_split_kv_emulation_matches_plain(sq, g, n_sm):
    """Many splits (most past slot 1's and slot 2's last page: empty) and
    few; ragged row tiles at sq * g = 224.  atol 1e-5: f32 on both sides,
    only the order of the sums differs."""
    q, k, v, table, pos = (torch.from_numpy(a) for a in _split_inputs(sq + g, sq, g))
    n_rt, pps, n_split = PA.plan_splits(3, 2, sq * g, 12, 8, 16, n_sm)
    if n_sm == 132:
        assert n_split > 3, "the idle and short slots must leave empty splits"
    emu = split_kv_emulation(q, k, v, table, pos, n_sm=n_sm)
    plain = PA.paged_attention_plain(q, k, v, table, pos)
    assert torch.isfinite(emu).all()
    torch.testing.assert_close(emu, plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sq", [1, 4])
def test_split_kv_emulation_window_and_fully_masked_rows(sq):
    """A window of 5 with a softcap; slot 1 sits past its table's end, so
    every key of its rows is masked: the plain version and the reference
    average V over the whole table there, and so do the splits (m stays
    NEG_INF in each, every weight is 1).  Held against the plain version
    and the reference at 1e-5."""
    q, k, v, table, pos = _split_inputs(3 * sq, sq, 7)
    pos[1] = 12 * 8 + 20
    tq, tk, tv, tt, tp = (torch.from_numpy(a) for a in (q, k, v, table, pos))
    emu = split_kv_emulation(tq, tk, tv, tt, tp, window=5, softcap=3.0)
    plain = PA.paged_attention_plain(tq, tk, tv, tt, tp, window=5, softcap=3.0)
    ref = np.asarray(jpaged_ref(*(jnp.asarray(a) for a in (q, k, v, table, pos)),
                                window=5, softcap=3.0))
    assert torch.isfinite(emu).all()
    torch.testing.assert_close(emu, plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)
    # slot 1: every key masked -> the mean of V over its 12 pages
    kvh, g = 2, 7
    gathered = tv[tt[1].long()].reshape(-1, kvh, 16).mean(0)
    want = gathered.repeat_interleave(g, 0)
    torch.testing.assert_close(emu[1], want[None].expand(sq, -1, -1), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# TF32 and 3xTF32
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits, nearest even) on its f32
    bits."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def tf32_matmul(a, b, passes):
    """a @ b as the tensor cores form it from tf32 operands (products
    exact, summed in f64 here): one pass tf32(a) tf32(b); three passes
    hi.hi + hi.lo + lo.hi with lo = tf32(x - hi)."""
    ah, bh = tf32(a).double(), tf32(b).double()
    if passes == 1:
        return (ah @ bh).float()
    al, bl = tf32(a - ah.float()).double(), tf32(b - bh.float()).double()
    return (ah @ bh + ah @ bl + al @ bh).float()


def tf32_paged(q, k, v, table, pos, passes, k_scale=None, v_scale=None):
    """Paged attention with both products in ``passes``-pass TF32 and the
    softmax in f32."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    kk = k[table.long()].reshape(b, -1, kvh, dh).float()
    vv = v[table.long()].reshape(b, -1, kvh, dh).float()
    if k_scale is not None:
        kk = kk * k_scale[table.long()].reshape(b, -1, kvh, 1)
        vv = vv * v_scale[table.long()].reshape(b, -1, kvh, 1)
    kpos = torch.arange(kk.shape[1])
    out = torch.empty_like(q)
    for bi in range(b):
        qpos = int(pos[bi]) + torch.arange(sq).repeat_interleave(g)
        allow = kpos[None] <= qpos[:, None]
        for hh in range(kvh):
            qr = q[bi, :, hh * g:(hh + 1) * g].reshape(sq * g, dh)
            s = tf32_matmul(qr, kk[bi, :, hh].T, passes) * dh ** -0.5
            p = torch.softmax(torch.where(allow, s, torch.tensor(PA.NEG_INF)), -1)
            o = tf32_matmul(p, vv[bi, :, hh], passes)
            out[bi, :, hh * g:(hh + 1) * g] = o.reshape(sq, g, dh)
    return out


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
def test_three_tf32_passes_meet_the_f32_tolerance_and_one_does_not(mode, sq):
    """The inputs of ``test_cuda_paged_attention_matches_plain`` (b 3, h 4
    over 2 KV heads, dh 64, pages of 16): one TF32 product misses its atol
    1e-4 (about 1e-3); 3xTF32 stays within it by two orders of
    magnitude."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((3, sq, 4, 64)).astype(np.float32)
    k = rng.standard_normal((8, 16, 2, 64)).astype(np.float32)
    v = rng.standard_normal((8, 16, 2, 64)).astype(np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([4 * 16 - sq, 5, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, table, pos)]
    kw = {}
    if mode == "int8":
        parts = quantize_kv(t[1], t[2])
        t[1], t[2] = parts["k"], parts["v"]
        kw = {"k_scale": parts["k_scale"], "v_scale": parts["v_scale"]}
    plain = PA.paged_attention_plain(*t, **kw)
    err3 = float((tf32_paged(*t, 3, **kw) - plain).abs().max())
    err1 = float((tf32_paged(*t, 1, **kw) - plain).abs().max())
    assert err3 <= 1e-6, err3
    assert err1 > 1e-4, err1


def test_tf32_rounding_is_nearest_even():
    """Ties at the 13th bit go to the even 10-bit mantissa; the split's
    remainder is exact and itself tf32."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2 ** -20,
                      -(one + ulp / 2)], dtype=torch.float32)
    torch.testing.assert_close(
        tf32(x), torch.tensor([one, one + 2 * ulp, one + ulp, -one]), rtol=0, atol=0)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi.double() + lo.double()) - y.double()).abs().max()
                 / y.abs().max()) < 2.0 ** -21
