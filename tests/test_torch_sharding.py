"""The port's sharding rules, activation constraint, collectives'
arithmetic, pipeline helpers and expert-sharding hook against the JAX
reference, in one process with no ranks (``parallel/sharding.py``,
``act_sharding.py``, ``collectives.py``, ``pipeline.py``,
``optim/compress.py``, ``launch/mesh.py``, ``models/moe.py``).

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices),
its collectives under ``jax.vmap(..., axis_name=...)`` on one CPU device.
The port's params come from the meta device (full width, no memory); the
reference's from ``jax.eval_shape``.  The reference stacks the per-layer
leaves on a leading [L, ...] dim with a replicated spec entry, the port
keeps a list of per-layer dicts, so a port leaf's spec must equal the
reference's with that entry dropped.  Rank-spanning behaviour (the
sharded train step, real collectives, the pipeline, the checkpoint) is in
``tests/test_torch_distributed.py``.
"""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as JT
from repro.optim import compress as jcompress
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jsh
from repro.parallel.act_sharding import activation_sharding as jact_ctx

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as M
from repro_torch.models import moe as E
from repro_torch.models import transformer as T
from repro_torch.models.attention import init_cache
from repro_torch.optim import compress
from repro_torch.parallel import act_sharding as AS
from repro_torch.parallel import collectives as C
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel import sharding as SH
from repro_torch.quantize import calibrate_model
from repro_torch.serve.kvcache import init_int8_cache

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
EF_RTOL = 1e-6          # the compressed sum and residual, port vs reference
MATMUL_ATOL = 1e-5      # the ring matmul, one f32 product a block


def _amesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _plan(name):
    shape, names = MESHES[name]
    return dict(zip(names, shape))


def _ref(spec):
    """A reference spec as the port's tuple."""
    return tuple(spec)


# ---------------------------------------------------------------------------
# fit_spec: the reference's own cases
# ---------------------------------------------------------------------------

FIT_CASES = [
    ((2, 4), ("data", "model"), (16, 64), ("data", "model")),
    ((2, 4), ("data", "model"), (3, 64), ("data", "model")),
    ((2, 4), ("data", "model"), (8, 6), (("data",), "model")),
    ((1, 1), ("data", "model"), (3, 7), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 64),
     (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (6, 64), (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 8), ("model", "model")),
    ((2, 4), ("data", "model"), (50304, 768), ("model", "data")),
    ((2, 2, 2), ("pod", "data", "model"), (50257, 12), (("pod", "data"),
                                                        "model")),
]


@pytest.mark.parametrize("case", range(len(FIT_CASES)))
def test_fit_spec_matches_reference(case):
    shape_m, names, shape, wanted = FIT_CASES[case]
    amesh = AbstractMesh(shape_m, names)
    want = jsh.fit_spec(amesh, shape, wanted)
    got = SH.fit_spec(dict(zip(names, shape_m)), shape, wanted)
    assert got == _ref(want)
    assert SH.shard_shape(shape, got, dict(zip(names, shape_m))) == \
        NamedSharding(amesh, want).shard_shape(shape)


def test_fit_spec_drops_and_does_not_reuse():
    plan = {"pod": 2, "data": 2, "model": 2}
    assert SH.fit_spec(plan, (6, 64), (("pod", "data"), "model")) == \
        ("pod", "model")
    assert SH.fit_spec(plan, (8, 8), ("model", "model")) == ("model", None)
    assert SH.mesh_axis_size(plan, ("pod", "data")) == 4
    assert SH.mesh_axis_size(plan, None) == 1
    assert SH.dp_axes(plan) == ("pod", "data")
    assert SH.dp_axes({"data": 2, "model": 4}) == ("data",)


# ---------------------------------------------------------------------------
# param_specs: every config at full width, both meshes, fsdp on and off
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """arch -> (the port's meta-device params, the reference's abstract
    params)."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch)
        out[arch] = (T.init_params(get_config(arch), 0, device="meta"),
                     jax.eval_shape(lambda c=jcfg: JT.init_params(
                         c, jax.random.PRNGKey(0))))
    return out


def _port_leaves(tree, path=""):
    """(path without list indices, index or None, leaf) of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for p, _, leaf in _port_leaves(v, path):
                yield p, i, leaf
    else:
        yield path, None, tree


def _ref_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_every_arch_is_covered():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 11


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_reference(trees, arch, mesh, fsdp):
    """Every leaf: the reference's spec less its stacked leading entry, and
    the reference's shard shape less its stacked leading dim."""
    tparams, jparams = trees[arch]
    amesh = _amesh(mesh)
    jspecs = jsh.param_specs(jget_config(arch), jparams, amesh, fsdp=fsdp)
    tspecs = SH.param_specs(get_config(arch), tparams, _plan(mesh), fsdp=fsdp)
    n = 0
    for (path, idx, spec), (_, _, leaf) in zip(_port_leaves(tspecs),
                                               _port_leaves(tparams)):
        jleaf = _ref_leaf(jparams, path)
        jspec = _ref(_ref_leaf(jspecs, path).spec)
        jspec = jspec + (None,) * (jleaf.ndim - len(jspec))
        jshard = NamedSharding(amesh, P(*jspec)).shard_shape(jleaf.shape)
        if idx is not None:            # stacked in the reference
            assert jspec[0] is None, (path, jspec)
            jspec, jshard, jshape = jspec[1:], jshard[1:], jleaf.shape[1:]
        else:
            jshape = jleaf.shape
        assert tuple(leaf.shape) == tuple(jshape), path
        assert spec == jspec, (arch, path, spec, jspec)
        assert SH.shard_shape(leaf.shape, spec, _plan(mesh)) == tuple(jshard)
        n += 1
    assert n == len(list(_port_leaves(tparams)))


def test_gpt2_vocab_drops_an_axis():
    """gpt2's padded vocab 50304 = 2^7 x 393: on (2, 2, 2) the embedding
    keeps model over the vocab and data over d_model; at fsdp off only
    model."""
    emb = T.init_params(get_config("gpt2-small"), 0, device="meta")["embed"]
    assert SH.leaf_spec("embed", emb.shape, {"data": 2, "model": 4}) == \
        ("model", "data")
    assert SH.leaf_spec("embed", (50257, 768), {"data": 2, "model": 4}) == \
        (None, "data")


# ---------------------------------------------------------------------------
# batch, cache and activation specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_reference(mesh):
    batch = {"tokens": np.zeros((8, 32), np.int32),
             "labels": np.zeros((8, 32), np.int32),
             "mask": np.zeros((8, 32), np.float32),
             "patches": np.zeros((8, 4, 16), np.float32),
             "odd": np.zeros((3, 5), np.int32)}
    jspecs = jsh.batch_specs(_amesh(mesh), batch)
    tspecs = SH.batch_specs(_plan(mesh), batch)
    assert {k: _ref(v.spec) for k, v in jspecs.items()} == tspecs


@pytest.mark.parametrize("kvh", [4, 3])
def test_cache_specs_heads_then_sequence(kvh):
    """kv heads 4 divide model 2: head-sharded; 3 do not: sequence-sharded
    (the reference test's case), and every other cache array."""
    amesh = AbstractMesh((2, 2), ("data", "model"))
    plan = {"data": 2, "model": 2}
    base = get_config("gpt2-small", reduced=True)
    cfg = base.replace(n_kv_heads=kvh)
    jcfg = jget_config("gpt2-small", reduced=True).replace(n_kv_heads=kvh)
    L, b, s, dh = cfg.n_layers, 2, 8, cfg.head_dim
    tree = {"k": np.zeros((L, b, s, kvh, dh), np.float32),
            "v": np.zeros((L, b, s, kvh, dh), np.float32),
            "k_scale": np.zeros((L, b, s, kvh, 1), np.float32),
            "conv_x": np.zeros((L, b, 3, 64), np.float32),
            "conv_bc": np.zeros((L, b, 3, 32), np.float32),
            "ssm": np.zeros((L, b, 8, 16, 8), np.float32),
            "memory": np.zeros((b, 30, 64), np.float32),
            "pos": np.zeros((b,), np.int32)}
    jspecs = jsh.cache_specs(jcfg, amesh, tree)
    tspecs = SH.cache_specs(cfg, plan, tree)
    assert {k: _ref(v.spec) for k, v in jspecs.items()} == tspecs
    want_k = ((None, "data", None, "model", None) if kvh == 4
              else (None, "data", "model", None, None))
    assert tspecs["k"] == want_k and tspecs["pos"] == (None,)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_spec_matches_reference(mesh, seq_shard):
    want = jsh.activation_spec(_amesh(mesh), seq_shard=seq_shard).spec
    assert SH.activation_spec(_plan(mesh), seq_shard) == _ref(want)
    assert SH.replicated(_plan(mesh)) == _ref(jsh.replicated(
        _amesh(mesh)).spec)


class _Names:
    """What ``placements`` reads of a DeviceMesh."""

    def __init__(self, names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None, "model"), ["S0", "S0", "S2"]),
    (("model", "data"), ["R", "S1", "S0"]),
    ((None, None), ["R", "R", "R"]),
    (("data",), ["R", "S0", "R"]),
])
def test_placements_against_shard_shape(spec, want):
    """Shard(d) per mesh dim that a dim names, Replicate elsewhere; the
    shard shape that the placements imply equals the reference's."""
    names = ("pod", "data", "model")
    got = SH.placements(spec, _Names(names))
    assert [("S%d" % p.dim) if p.is_shard() else "R" for p in got] == want
    shape = (8, 4, 64)[:len(spec)]
    implied = list(shape)
    for size, p in zip((2, 2, 2), got):
        if p.is_shard():
            implied[p.dim] //= size
    amesh = AbstractMesh((2, 2, 2), names)
    assert tuple(implied) == NamedSharding(amesh, P(*spec)).shard_shape(shape)
    assert SH.shard_shape(shape, spec, dict(zip(names, (2, 2, 2)))) == \
        tuple(implied)


def test_placements_refuse_a_reversed_entry():
    with pytest.raises(ValueError, match="mesh order"):
        SH.placements((("data", "pod"),), _Names(("pod", "data", "model")))


def test_shard_slices_cut_major_to_minor():
    plan = {"pod": 2, "data": 2, "model": 2}
    full = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    parts = {}
    for p_ in range(2):
        for d_ in range(2):
            for m_ in range(2):
                coord = {"pod": p_, "data": d_, "model": m_}
                parts[(p_, d_, m_)] = SH.local_shard(full, spec, plan, coord)
    assert torch.equal(parts[(1, 0, 1)], full[4:6, 3:6])
    rows = torch.cat([parts[(p_, d_, 0)] for p_ in range(2)
                      for d_ in range(2)])
    assert torch.equal(rows, full[:, :3])


# ---------------------------------------------------------------------------
# act_sharding: the constraint and the cache write mode
# ---------------------------------------------------------------------------

def test_constrain_is_a_noop_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert AS.constrain(x) is x
    with AS.activation_sharding((("data",), None, None)):
        assert AS.constrain(x) is x                 # a plain tensor
        assert AS.constrain(x[0]) is not None       # rank mismatch: as is
    with jact_ctx(None):                            # the reference's, unset
        pass
    with pytest.raises(ValueError, match="select"):
        AS.set_cache_update_mode("scatter")
    assert AS.cache_update_mode() == "dus"


@pytest.mark.parametrize("cache_kind", ["f32", "int8"])
@pytest.mark.parametrize("arch", ["gpt2-small", "qwen2-0.5b"])
def test_select_and_dus_decode_writes_bit_equal(arch, cache_kind):
    """Prefill, then 5 decode steps: the "select" write gives the same
    caches and logits, bit for bit, as the indexed write."""
    torch.manual_seed(0)
    cfg = get_config(arch, reduced=True)
    params = T.init_params(cfg, 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 6))
    nxt = torch.randint(0, cfg.vocab_size, (5, 2, 1))
    runs = {}
    for mode in ("dus", "select"):
        cache = (init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
                 if cache_kind == "f32"
                 else init_int8_cache(cfg, 2, 16, device="cpu"))
        AS.set_cache_update_mode(mode)
        try:
            with torch.no_grad():
                out = T.forward(cfg, params, tokens, cache=cache)
                cache, logits = out["cache"], [out["logits"]]
                for t in nxt:
                    lg, cache = T.decode_step(cfg, params, t, cache)
                    logits.append(lg)
        finally:
            AS.set_cache_update_mode("dus")
        runs[mode] = (cache, logits)
    (c0, l0), (c1, l1) = runs["dus"], runs["select"]
    assert set(c0) == set(c1)
    for k in c0:
        assert torch.equal(c0[k], c1[k]), k
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The collectives' arithmetic: the reference under vmap
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A gloo process group of one rank in this process, destroyed after
    the module (other test files expect none)."""
    if dist.is_initialized():
        pytest.fail("a process group is already initialized in this worker")
    path = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _ref_ef(g, err):
    """The reference's ef_compressed_psum over len(g) ranks."""
    tot, new_err = jax.vmap(lambda a, b: jcompress.ef_compressed_psum(
        a, b, "data"), axis_name="data")(jnp.asarray(g), jnp.asarray(err))
    return np.asarray(tot), np.asarray(new_err)


def _codes(acc, err, s):
    return np.round((acc.astype(np.float64) - err) / s).astype(np.int64)


@pytest.mark.parametrize("n_ranks", [1, 8])
def test_ef_compressed_psum_matches_reference(n_ranks):
    """The per-rank arithmetic as a loop of local shards (shared amax, one
    ``ef_quantize`` a rank, the int sum): the same int8 codes as the
    reference, the total and the residual within EF_RTOL; 20 repeats keep
    the residual bounded."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(n_ranks, 64)).astype(np.float32)
    err = np.zeros_like(g)
    for rep in range(3):
        want_tot, want_err = _ref_ef(g, err)
        acc = [torch.from_numpy(g[r]) + torch.from_numpy(err[r])
               for r in range(n_ranks)]
        amax = torch.stack([a.abs().max() for a in acc]).max()
        qs = [compress.ef_quantize(a, amax) for a in acc]
        s = qs[0][1]
        total = torch.stack([q for q, _ in qs]).sum(0).float() * s
        new_err = np.stack([(a - q.float() * s).numpy()
                            for a, (q, _) in zip(acc, qs)])
        s_np = float(s)
        for r in range(n_ranks):
            assert np.array_equal(qs[r][0].numpy(),
                                  _codes(acc[r].numpy(), want_err[r], s_np))
            assert np.abs(qs[r][0].numpy()).max() <= 127
        scale = np.abs(want_tot).max()
        assert np.abs(total.numpy() - want_tot[0]).max() <= EF_RTOL * scale
        assert np.abs(new_err - want_err).max() <= EF_RTOL * scale
        err = new_err.astype(np.float32)
    if n_ranks == 8:
        exact = g.sum(0)
        rel = np.abs(want_tot[0] - exact).max() / np.abs(exact).max()
        assert rel < 0.05
    assert compress.init_error_state({"a": torch.ones(2, 3)})["a"].dtype == \
        torch.float32


def test_collectives_on_a_group_of_one(group1):
    """Every collective on a one-rank gloo group equals the reference
    under a size-1 vmap (and the identity it must be)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    got = C.hierarchical_psum(torch.from_numpy(x), group1, group1)
    want = jax.vmap(jax.vmap(lambda v: jcoll.hierarchical_psum(
        v, "data", "pod"), axis_name="data"), axis_name="pod")(
        jnp.asarray(x)[None, None])[0, 0]
    assert np.array_equal(got.numpy(), np.asarray(want))
    xs = rng.normal(size=(4, 32)).astype(np.float32)
    w = rng.normal(size=(32, 6)).astype(np.float32)
    got = C.allgather_matmul(torch.from_numpy(xs), torch.from_numpy(w), group1)
    want = jax.vmap(lambda a, b: jcoll.allgather_matmul(a, b, "tp"),
                    axis_name="tp")(jnp.asarray(xs)[None],
                                    jnp.asarray(w)[None])[0]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= MATMUL_ATOL
    got = C.ring_allreduce_reference(torch.from_numpy(xs), group1)
    assert np.array_equal(got.numpy(), xs)
    tot, new_err = compress.ef_compressed_psum(
        torch.from_numpy(x), torch.zeros(x.shape), group1)
    want_tot, want_err = _ref_ef(x[None], np.zeros_like(x)[None])
    assert np.abs(tot.numpy() - want_tot[0]).max() <= \
        EF_RTOL * np.abs(want_tot).max()
    assert C.axis_size(group1) == 1 and C.axis_index(group1) == 0
    # one-rank transport: a ring shift returns the tensor itself
    assert torch.equal(C.ring_shift(torch.arange(4.0), group1),
                       torch.arange(4.0))
    assert C.HOST_ROUTED["gloo"] == {"send", "recv"}


def test_mesh_needs_a_process_group_and_a_card():
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            M.make_host_mesh(2, 1, device="cpu")
        with pytest.raises(RuntimeError, match="process group"):
            M.make_production_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            M.make_host_mesh(1, 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        M.make_host_mesh(1, 1, device="meta")


# ---------------------------------------------------------------------------
# Pipeline helpers, the expert-sharding hook, calibration inputs
# ---------------------------------------------------------------------------

def test_split_stages_and_microbatch_shapes():
    from repro.parallel.pipeline import microbatch as jmicro
    from repro.parallel.pipeline import split_stages as jsplit
    x = torch.zeros(8, 3)
    assert PP.microbatch(x, 4).shape == jmicro(jnp.zeros((8, 3)), 4).shape
    ws = {"w": torch.zeros(8, 5), "b": {"c": torch.zeros(8, 2, 2)}}
    st = PP.split_stages(ws, 2)
    jst = jsplit({"w": jnp.zeros((8, 5)), "b": {"c": jnp.zeros((8, 2, 2))}}, 2)
    assert st["w"].shape == jst["w"].shape == (2, 4, 5)
    assert st["b"]["c"].shape == jst["b"]["c"].shape
    layers = [{"i": i} for i in range(12)]
    runs = PP.split_stages(layers, 4)
    assert [[lp["i"] for lp in r] for r in runs] == \
        [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    with pytest.raises(ValueError):
        PP.split_stages(layers, 5)
    with pytest.raises(ValueError):
        PP.microbatch(x, 3)


@pytest.mark.parametrize("train", [False, True])
def test_expert_sharding_hook_sees_the_dispatch_buffer(train):
    """``set_expert_sharding``'s callable gets the [g, e, C, d] buffer's
    shape; on a plain tensor its spec changes nothing."""
    cfg = get_config("dbrx-132b", reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 10),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        base = T.forward(cfg, params, tokens, train=train)
    seen = []

    def spec_fn(shape):
        seen.append(shape)
        return (("data",), "model", None, None)

    E.set_expert_sharding(spec_fn)
    try:
        assert E._expert_sharding() is spec_fn
        with torch.no_grad():
            out = T.forward(cfg, params, tokens, train=train)
    finally:
        E.set_expert_sharding(None)
    assert E._expert_sharding() is None
    cap = E._capacity(cfg, 10, factor=1.25 if train else None)
    assert seen == [(3, cfg.n_experts, cap, cfg.d_model)] * cfg.n_layers
    assert torch.equal(out["logits"], base["logits"])
    assert torch.equal(out["aux"], base["aux"])


def test_calibrate_model_takes_tensors_and_numpy():
    """The default calibration forward takes numpy, lists and tensors (a
    CUDA batch on the card): the same stats from each."""
    cfg = get_config("gpt2-small", reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, (2, 12)) for _ in range(2)]
    runs = [calibrate_model(cfg, params, [{"tokens": f(t)} for t in toks],
                            device="cpu")
            for f in (np.asarray, torch.as_tensor, lambda t: t.tolist())]
    for stats, kv in runs[1:]:
        assert set(stats.sites) == set(runs[0][0].sites)
        for k, v in stats.sites.items():
            w = runs[0][0].sites[k]
            assert np.array_equal(v.absmax, w.absmax)
            assert np.array_equal(v.absmean, w.absmean)
            assert v.count == w.count
