"""The port's analysis layer against the JAX reference
(``repro_torch/analysis/roofline.py`` and ``hlo.py``, the transport's
recorder in ``parallel/collectives.py`` and the kernel sites'
accounting).

The roofline's counts are pure arithmetic and must equal the reference's
integers; its time terms use the H100's constants where the reference
uses a TPU's.  The reference parses collectives out of HLO text; the port
records them at its transport, so the same three ops, run through the
port's wrappers on a fake world, must price the same.  Every fake world
is opened and destroyed inside a fixture: other files in the same worker
expect no process group.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro.configs import get_config as jget_config

from repro_torch.analysis import hlo as H
from repro_torch.analysis import roofline as R
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core.context import FpCtx
from repro_torch.kernels import accounting
from repro_torch.kernels import muxq_gemm as G
from repro_torch.kernels import quantize as RQ
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import spmd

ALL = list(ARCHS)      # the 10 assigned archs and gpt2-small


@pytest.fixture
def world():
    """A fake world of 8 ranks, this process rank 0."""
    def open_(size):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    yield open_
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_param_count_and_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for active in (False, True):
        assert R.param_count(cfg, active) == jroof.param_count(jcfg, active)
    for mode in ("train", "prefill", "decode"):
        assert R.model_flops(cfg, 4096 * 256, mode) == \
            jroof.model_flops(jcfg, 4096 * 256, mode)


def test_make_roofline_on_the_reference_inputs():
    """The reference test's inputs: the same counts and dominant term,
    the time terms on the H100's constants."""
    args = ({"flops": 1e15, "bytes accessed": 1e12}, {"total": 1e11})
    kw = dict(tokens=4096 * 256, mode="train", chips=256)
    r = R.make_roofline(*args, get_config("qwen2-0.5b"), **kw)
    j = jroof.make_roofline(*args, jget_config("qwen2-0.5b"), **kw)
    assert (r.hlo_flops, r.hlo_bytes, r.coll_bytes, r.model_flops) == \
        (j.hlo_flops, j.hlo_bytes, j.coll_bytes, j.model_flops)
    assert r.dominant == j.dominant == "compute"
    assert r.compute_s == pytest.approx(1e15 / 989e12)
    assert r.memory_s == pytest.approx(1e12 / 3.35e12)
    assert r.collective_s == pytest.approx(1e11 / 450e9)
    assert r.compute_s_int8 == r.compute_s
    assert 0 < r.mfu_bound < 1
    assert r.useful_fraction == pytest.approx(j.useful_fraction)
    half = R.make_roofline(*args, get_config("qwen2-0.5b"), **kw,
                           int8_fraction=0.5)
    assert half.compute_s_int8 == pytest.approx(0.5e15 / 989e12
                                                + 0.5e15 / 1979e12)


def test_no_tpu_constant_in_the_port():
    for name in ("PEAK_BF16", "PEAK_INT8", "HBM_BW"):
        assert getattr(R, name) != getattr(jroof, name)
    assert (R.PEAK_BF16, R.PEAK_INT8, R.PEAK_F32, R.HBM_BW, R.NVLINK_BW) == \
        (989e12, 1979e12, 67e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# collectives: the transport's records against the reference's HLO parse
# ---------------------------------------------------------------------------

REF_HLO = """
  %ag = f32[64,128]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[32]{0} all-reduce(%y), replica_groups=[8,4]<=[32]
  %cp = s8[16]{0} collective-permute(%z), source_target_pairs={{0,1}}
"""
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _check_against_reference(out):
    ref = jhlo.collective_bytes(REF_HLO)
    for k in KINDS + ("total",):
        assert out[k] == pytest.approx(ref[k]), k
    assert {k: out["counts"][k] for k in KINDS} == ref["counts"]
    assert out["broadcast"] == 0.0


def test_collective_bytes_of_records_equals_the_reference_parse():
    out = H.collective_bytes([("all-gather", 64 * 128 * 4, 4),
                              ("all-reduce", 32 * 2, 4),
                              ("send", 16, 2), ("recv", 16, 2)])
    _check_against_reference(out)
    assert H.shape_bytes((16, 128), torch.bfloat16) == \
        jhlo.shape_bytes("bf16[16,128]")
    assert H.shape_bytes(torch.empty(8, 8)) == jhlo.shape_bytes("f32[8,8]")


def test_the_transport_records_the_reference_ops(world):
    """The HLO's three ops, run through the port's wrappers on a fake
    world of 8 (groups of 4 and 2, meta tensors): the same wire bytes and
    counts; nothing recorded outside ``recording``."""
    world(8)
    g4, g2 = dist.new_group([0, 1, 2, 3]), dist.new_group([0, 1])
    meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
    before = dict(C.HOST_COPIES)
    with C.recording() as recs:
        C.all_gather(meta((16, 128), torch.float32), g4)
        C.all_reduce(meta((32,), torch.bfloat16), "sum", g4)
        C.ring_shift(meta((16,), torch.int8), g2)
    C.all_reduce(meta((32,), torch.bfloat16), "sum", g4)
    assert recs == [("all-gather", 64 * 128 * 4, 4), ("all-reduce", 64, 4),
                    ("recv", 16, 2), ("send", 16, 2)]
    _check_against_reference(H.collective_bytes(recs))
    assert C.HOST_COPIES == before
    with C.recording() as recs:
        C.broadcast(meta((10,), torch.float32), 1, g4)
        C.reduce_scatter(meta((8, 4), torch.float32), g4)
    out = H.collective_bytes(recs)
    assert out["broadcast"] == 40.0
    assert out["reduce-scatter"] == 3 * 2 * 4 * 4
    assert out["counts"]["broadcast"] == 1


def test_the_sharded_step_records_what_spmd_implies(world):
    """gpt2 REDUCED, the sharded step at (2, 2) on a fake world: one
    all-gather a sharded mesh dim of each leaf (the params gathered at
    the start), then all-reduces over the data-parallel pair: one a
    gradient leaf, the cross-entropy's token count, and the metrics; and
    one over all four ranks, the clipping norm."""
    world(4)
    cfg = get_config("gpt2-small", reduced=True)
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    shape = SP.ShapeSpec("t", 32, 8, "train")
    step, args, _ = D.train_program(cfg, shape, mesh, "fp")
    out = D.trace(step, args)
    specs = SH.param_specs(cfg, T.init_params(cfg, device="meta"), mesh)
    leaves = spmd.spec_leaves(specs)
    p_leaves = [t for t in _leaves(T.init_params(cfg, device="meta"))]
    sizes = {"data": 2, "model": 2}
    ag = [(n, g) for spec, p in zip(leaves, p_leaves)
          for n, g in _gathers(p, spec, sizes)]
    counts = out["coll"]["counts"]
    assert counts["all-gather"] == len(ag) > 0
    assert out["coll"]["all-gather"] == pytest.approx(
        sum(n * (g - 1) / g for n, g in ag))
    assert counts["all-reduce"] == len(p_leaves) + 3
    grads = sum(p.numel() * 4 for p in p_leaves)
    assert out["coll"]["all-reduce"] > grads * 2 * (2 - 1) / 2
    assert counts["collective-permute"] == counts["broadcast"] == 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _gathers(p, spec, sizes):
    """(result bytes, group size) of each all-gather ``full_tensor`` makes
    of a leaf: one a sharded mesh dim, the minor dim first."""
    spec = tuple(spec) + (None,) * (p.ndim - len(spec))
    local = list(SH.shard_shape(p.shape, spec, sizes))
    out = []
    for name in ("model", "data"):
        for d, e in enumerate(spec):
            if name in SH.entry_axes(e):
                local[d] *= sizes[name]
                out.append((int(np.prod(local)) * 4, sizes[name]))
    return out


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _train_trace(cfg):
    p = T.init_params(cfg, device="meta")
    b = {"tokens": torch.empty(2, 16, dtype=torch.int32, device="meta"),
         "labels": torch.empty(2, 16, dtype=torch.int32, device="meta")}
    with H.CostCounter() as k:
        ST.loss_and_grads(cfg, p, b, FpCtx())
    return k


def test_op_histogram_shows_the_forward_again_under_remat():
    """With ``remat`` each layer's forward runs again in the backward:
    the matmul flops grow by the layers' forward (the whole forward less
    the tied head's product; torch's checkpoint stops recomputing once the
    backward has what it needs, so a layer's last product may be left
    out), and so does the histogram's matmul count."""
    cfg = get_config("gpt2-small", reduced=True)
    plain, remat = _train_trace(cfg), _train_trace(cfg.replace(remat=True))
    with H.CostCounter() as fwd:
        T.forward(cfg, T.init_params(cfg, device="meta"),
                  torch.empty(2, 16, dtype=torch.int32, device="meta"),
                  FpCtx())
    head = 2 * 32 * cfg.d_model * T.init_params(
        cfg, device="meta")["embed"].shape[0]
    last = 2 * 32 * cfg.d_ff * cfg.d_model * cfg.n_layers   # mlp_down
    assert (fwd.flops - head - last <= remat.flops - plain.flops
            <= fwd.flops - head)
    hp, hr = H.op_histogram(plain.ops, 40), H.op_histogram(remat.ops, 40)
    assert hr["mm"] > hp["mm"]
    assert list(H.op_histogram({"a": 1, "b": 5, "c": 3}, 2)) == ["b", "c"]


def test_counter_bytes_flops_and_peak_of_a_small_program():
    """mm of [4, 8] @ [8, 16] f32: 2·4·8·16 flops; its operands and output
    once; a view moves nothing; the peak holds the arguments and the
    product, and the product is the step's new output."""
    a, b = torch.randn(4, 8), torch.randn(8, 16)
    k = H.CostCounter()
    k.arguments((a, b))
    with k:
        y = (a @ b).view(64)
    k.outputs(y)
    assert k.flops == 2 * 4 * 8 * 16
    assert k.bytes == (32 + 128 + 64) * 4
    mem = k.memory()
    assert mem["argument_size_in_bytes"] == (32 + 128) * 4
    assert mem["output_size_in_bytes"] == 64 * 4
    assert mem["peak_size_in_bytes"] == (32 + 128 + 64) * 4
    assert k.ops == {"mm": 1, "view": 1}


def test_kernel_sites_count_their_shapes_not_the_plain_ops():
    """Inside a counter, ``rowwise_quantize`` and ``muxq_gemm`` add their
    analytic work (the reckoning of ``chip_smoke.py``'s bounds) and none
    of their plain version's aten ops; outside one they cost nothing."""
    m, k, n, bk = 4, 512, 64, 512
    x = torch.randn(m, k)
    gi = torch.arange(k, dtype=torch.int32)
    sc = torch.ones(k)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8).T
    bs, sw = torch.ones(1, dtype=torch.int32), torch.ones(1, n)
    with H.CostCounter() as c:
        q, s = RQ.rowwise_quantize(x, 8, gather_idx=gi, in_scale=sc)
        G.muxq_gemm(q, w, bs, s, sw, bk=bk)
    assert c.kernels["rowwise_quantize"] == {
        "calls": 1, "ops": 4 * m * k, "bytes": m * k * 4 + k * 8 + m * k + 4 * m}
    assert c.kernels["muxq_gemm"] == {
        "calls": 1, "ops": 2 * m * n * k,
        "bytes": m * k + k * n + 4 * (k // bk + m + n) + 4 * m * n}
    assert c.ops == {}
    assert c.int8_ops == 2 * m * n * k
    assert c.flops == 4 * m * k + 2 * m * n * k
    assert accounting._COUNTER is None
