"""Distributed training of the port on gloo ranks spawned on the CPU: the
sharded train step, the collectives, the GPipe schedule, the int8
error-feedback all-reduce and the sharded checkpoint — the port's
counterpart of ``tests/test_distributed.py``.

The ranks are spawned once per world size (2 and 4; ``parallel.ranks.
run_ranks``), each running every scenario below with one intra-op thread
(CPU sums in a fixed order).  The claims:

* the sharded step (``parallel/spmd.py``) at mesh (data 2, model 1) and
  (2, 2), on reduced qwen2-0.5b with a loss mask and on reduced dbrx-132b
  (the MoE aux loss and capacity drops), gives the port's single-device
  ``make_train_step``'s loss and grad norm within LOSS_RTOL and its params
  and moments within PARAM_ATOL after 3 steps, and every rank stores
  exactly its reference shard (``NamedSharding.shard_shape`` on an
  ``AbstractMesh``) of every param and moment;
* the collectives across real ranks equal the reference's under
  ``jax.vmap``: ``hierarchical_psum`` and ``ring_allreduce_reference``
  exactly, ``allgather_matmul`` within MATMUL_ATOL, ``ef_compressed_psum``
  with the same int8 codes and its totals within EF_RTOL;
* ``pipeline_apply`` at 4 stages equals the unpipelined stack within
  1e-5 (the reference's tolerance);
* a checkpoint saved at (2, 2) restores bit-equal at (4, 1) and (1, 4),
  and one written by the JAX package restores sharded, bit-equal.

This module imports no JAX at top level: the ranks import it by name to
find their function.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as E
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ranks import run_ranks

TIMEOUT_S = 300.0
N_STEPS = 3
ACFG = dict(lr=3e-3, total_steps=20, warmup_steps=2)
STEP_ARCHS = ("qwen2-0.5b", "dbrx-132b")
MESH_OF = {2: (2, 1), 4: (2, 2)}
LOSS_RTOL = 1e-6         # loss, ce, aux, grad_norm: f32 sums in other orders
PARAM_ATOL = 1e-5        # params and moments after 3 steps (lr 3e-3)
EF_RTOL = 1e-6           # compressed totals and residuals, of the scale
EF_NORM_RTOL = 0.15      # the compressed step's grad norm (8.1 % measured)
MATMUL_ATOL = 1e-5
PIPE_ATOL = 1e-5         # the reference test's
PIPE = dict(n_stages=4, L=8, n_micro=4, mb=2, d=16)


def _batches(cfg, arch, b=4):
    """N_STEPS batches.  qwen2's (16 tokens a row) carry a loss mask with
    one row masked out (a shard whose own token count is small).  dbrx's
    rows are 32 tokens, past its capacity of 24 slots an expert a row, and
    row 0 repeats one token, so that its tokens all pick the same experts
    and the training dispatch drops some."""
    rng = np.random.default_rng(1)
    s = 16 if arch == "qwen2-0.5b" else 32
    out = []
    for _ in range(N_STEPS):
        bt = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
              for k in ("tokens", "labels")}
        if arch == "qwen2-0.5b":
            m = (rng.random((b, s)) < 0.7).astype(np.float32)
            m[1, :] = 0.0
            bt["mask"] = m
        else:
            bt["tokens"][0, :] = 7
        out.append(bt)
    return out


def _np(tree):
    return adamw.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _sharded_run(arch, mesh, compress_grads=False, n_steps=N_STEPS):
    from repro_torch.parallel import spmd
    cfg = get_config(arch, reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    specs, dparams, state = spmd.init_sharded(cfg, params, mesh)
    step = spmd.make_sharded_train_step(
        cfg, mesh, specs, adamw.AdamWConfig(**ACFG),
        compress_grads=compress_grads, device="cpu")
    metrics = []
    for batch in _batches(cfg, arch)[:n_steps]:
        dparams, state, m = step(dparams, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    local = lambda tree: _np(adamw.tree_map(lambda t: t.to_local(), tree))
    return {"metrics": metrics, "coord": SH.coordinate(mesh),
            "specs": specs, "params": local(dparams),
            "mu": local(state["mu"]), "nu": local(state["nu"]),
            "bytes": (spmd.local_bytes([dparams, state["mu"], state["nu"]]),
                      spmd.global_bytes([dparams, state["mu"],
                                         state["nu"]]))}


def _pipeline(rank, ws, x):
    from repro_torch.parallel import pipeline as PP
    ws, x = torch.from_numpy(ws), torch.from_numpy(x)

    def block_fn(stage_ws, h):
        for w in stage_ws:
            h = torch.tanh(h @ w)
        return h

    staged = PP.split_stages(list(ws), PIPE["n_stages"])
    out = PP.pipeline_apply(block_fn, staged[rank],
                            PP.microbatch(x, PIPE["n_micro"]))
    return out.numpy()


def _rank(rank, world, inputs, out_dir):
    """One rank of a ``world``-rank gloo group: every scenario."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import mesh as M
    from repro_torch.optim import compress
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import spmd

    res = {"steps": {a: _sharded_run(a, M.make_host_mesh(
        *MESH_OF[world], device="cpu")) for a in STEP_ARCHS}}
    try:
        M.make_production_mesh(device="cpu")
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)
    if world == 2:
        return res
    mesh = M.make_host_mesh(2, 2, device="cpu")
    res["compressed"] = _sharded_run("qwen2-0.5b", mesh, compress_grads=True)

    # the int8 error-feedback sum, 3 rounds with the residual carried
    g = torch.from_numpy(inputs["ef_g"][rank])
    err = torch.zeros_like(g)
    res["ef"] = []
    for _ in range(3):
        tot, err = compress.ef_compressed_psum(g, err)
        res["ef"].append((tot.numpy(), err.numpy()))

    res["pipeline"] = _pipeline(rank, inputs["pipe_ws"], inputs["pipe_x"])

    pod_data = M.make_mesh((2, 2), ("pod", "data"), device="cpu")
    coord = SH.coordinate(pod_data)
    x = torch.from_numpy(inputs["hier_x"][coord["pod"], coord["data"]])
    res["hier"] = C.hierarchical_psum(
        x, pod_data.get_group("data"), pod_data.get_group("pod")).numpy()

    xs = torch.from_numpy(inputs["mm_x"][rank])
    w = torch.from_numpy(inputs["mm_w"][rank])
    res["ring_mm"] = C.allgather_matmul(xs, w).numpy()
    res["ring_ar"] = C.ring_allreduce_reference(xs).numpy()
    res["host_copies"] = dict(C.HOST_COPIES)

    # the checkpoint: saved sharded at (2, 2), restored at (4, 1), (1, 4)
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    specs, dparams, state = spmd.init_sharded(cfg, params, mesh)
    step = spmd.make_sharded_train_step(cfg, mesh, specs,
                                        adamw.AdamWConfig(**ACFG),
                                        device="cpu")
    dparams, state, _ = step(dparams, state, _batches(cfg, "qwen2-0.5b")[0])
    ckpt.save(f"{out_dir}/ckpt", 1, dparams, state, extra={"world": world})
    res["saved"] = {"params": _np(SH.gather_tree(dparams)),
                    "mu": _np(SH.gather_tree(state["mu"]))}
    res["restored"] = {}
    for shape in ((4, 1), (1, 4)):
        m2 = M.make_host_mesh(*shape, device="cpu")
        sp2 = SH.param_specs(cfg, params, m2)
        p2, o2, meta = ckpt.restore(
            f"{out_dir}/ckpt", 1, params, adamw.init_state(params),
            shardings=sp2, opt_shardings={"mu": sp2, "nu": sp2}, mesh=m2)
        res["restored"][shape] = {
            "coord": SH.coordinate(m2), "specs": sp2, "meta": meta,
            "params": _np(adamw.tree_map(lambda t: t.to_local(), p2)),
            "mu": _np(adamw.tree_map(lambda t: t.to_local(), o2["mu"])),
            "step": int(o2["step"])}
    jp, _, _ = ckpt.restore(inputs["jax_ckpt"], 7, params,
                            shardings=specs, mesh=mesh)
    res["jax_restored"] = {"coord": SH.coordinate(mesh), "specs": specs,
                           "params": _np(adamw.tree_map(
                               lambda t: t.to_local(), jp))}
    dist.barrier()
    return res


# ---------------------------------------------------------------------------
# Fixtures: the single-device runs, the reference's values, the ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    """The port's single-device step on each arch: metrics per step and
    the params and moments after N_STEPS; dbrx's capacity drops counted."""
    out = {}
    dropped = []
    real = E._dispatch_group

    def counting(cfg, xf, probs, cap):
        res = real(cfg, xf, probs, cap)
        dropped.append(int((~res[4]).sum()))
        return res

    for arch in STEP_ARCHS:
        cfg = get_config(arch, reduced=True)
        params = T.init_params(cfg, 0, device="cpu")
        state = adamw.init_state(params)
        step = make_train_step(cfg, adamw.AdamWConfig(**ACFG), device="cpu")
        metrics = []
        E._dispatch_group = counting
        try:
            for batch in _batches(cfg, arch):
                params, state, m = step(params, state, {
                    k: torch.as_tensor(v) for k, v in batch.items()})
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            E._dispatch_group = real
        out[arch] = {"metrics": metrics, "params": _np(params),
                     "mu": _np(state["mu"]), "nu": _np(state["nu"])}
    out["dropped"] = dropped
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs, and a checkpoint written by the JAX package."""
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro.configs import get_config as jget_config
    from repro.models import transformer as JT

    rng = np.random.default_rng(0)
    n, L, d = PIPE["n_stages"], PIPE["L"], PIPE["d"]
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jget_config("qwen2-0.5b", reduced=True), jax.random.PRNGKey(5)))
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save(jdir, 7, jparams)
    return {"ef_g": rng.normal(size=(4, 64)).astype(np.float32),
            "pipe_ws": (rng.normal(size=(L, d, d)) * 0.3).astype(np.float32),
            "pipe_x": rng.normal(size=(PIPE["n_micro"] * PIPE["mb"], d)
                                 ).astype(np.float32),
            "hier_x": np.arange(2 * 2 * 3 * 6 * 5, dtype=np.float32
                                ).reshape(2, 2, 3, 6, 5),
            "mm_x": rng.normal(size=(4, 4, 32)).astype(np.float32),
            "mm_w": rng.normal(size=(4, 32, 6)).astype(np.float32),
            "jax_ckpt": jdir, "jax_params": jparams}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    payload = {k: v for k, v in inputs.items() if k != "jax_params"}
    out = str(tmp_path_factory.mktemp("ranks"))
    return {w: run_ranks(_rank, w, (w, payload, out), backend="gloo",
                         timeout_s=TIMEOUT_S) for w in (2, 4)}


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for p, leaf in _leaves(v, path):
                yield f"{p}#{i}", leaf
    else:
        yield path, tree


def _spec_leaves(specs):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(specs)
    return out


def _assert_shards(run, full, mesh_shape, atol, what):
    """Every local leaf equals its slice of the full tree within ``atol``
    (0: bit-equal)."""
    plan = dict(zip(run["coord"], mesh_shape))
    full = dict(_leaves(full))
    assert len(full) == len(_spec_leaves(run["specs"]))
    for (path, loc), spec in zip(_leaves(run[what]),
                                 _spec_leaves(run["specs"])):
        whole = full[path]
        sl = SH.shard_slices(whole.shape, spec, plan, run["coord"])
        want = whole[sl]
        assert loc.shape == want.shape, (what, path)
        err = float(np.abs(loc.astype(np.float64) - want).max()) \
            if loc.size else 0.0
        assert err <= atol, (what, path, err)


@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_single_device(ranks, single, world, arch):
    ref = single[arch]
    for res in ranks[world]:
        run = res["steps"][arch]
        for got, want in zip(run["metrics"], ref["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                assert abs(got[k] - want[k]) <= LOSS_RTOL * max(
                    abs(want[k]), 1e-30), (world, arch, k, got[k], want[k])
        for what in ("params", "mu", "nu"):
            _assert_shards(run, ref[what], MESH_OF[world], PARAM_ATOL, what)


def test_dbrx_steps_drop_assignments_and_carry_an_aux_loss(single):
    """The MoE check is not vacuous: the training dispatch drops
    assignments past an expert's capacity and the aux loss is nonzero.
    Groups are batch rows, so a rank's rows hold whole groups and drop the
    same assignments."""
    assert sum(single["dropped"]) > 0
    assert all(m["aux"] > 0 for m in single["dbrx-132b"]["metrics"])
    assert all(m["aux"] == 0 for m in single["qwen2-0.5b"]["metrics"])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_stores_its_reference_shard(ranks, world):
    """Each rank's params, mu and nu leaves have the reference's
    ``NamedSharding.shard_shape`` (the stacked leading dim dropped), and
    the ranks hold 1/|mesh| of the sharded bytes together."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs import get_config as jget_config
    from repro.models import transformer as JT
    from repro.parallel.sharding import param_specs as jparam_specs
    amesh = AbstractMesh(MESH_OF[world], ("data", "model"))
    for arch in STEP_ARCHS:
        jcfg = jget_config(arch, reduced=True)
        jp = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
        jspecs = jparam_specs(jcfg, jp, amesh)
        for res in ranks[world]:
            run = res["steps"][arch]
            for what in ("params", "mu", "nu"):
                for path, loc in _leaves(run[what]):
                    key = path.split("#")[0]
                    node, sp = jp, jspecs
                    for k in key.split("/"):
                        node, sp = node[k], sp[k]
                    shard = NamedSharding(amesh, sp.spec).shard_shape(
                        node.shape)
                    if "#" in path:
                        shard = shard[1:]
                    assert loc.shape == tuple(shard), (arch, what, path)
            local, glob = run["bytes"]
            assert glob > local >= glob // (world * 2)


def test_production_mesh_refuses_a_small_world(ranks):
    for world in (2, 4):
        for res in ranks[world]:
            assert "256 ranks" in res["production"]


def test_compressed_step_tracks_the_exact_step(ranks, single):
    """``compress_grads``: the first loss is the exact step's (the loss
    comes before the reduction); the grad norm within EF_NORM_RTOL (one
    int8 scale a tensor, its abs-max over the ranks / 127: the many small
    entries of a gradient round to a few codes, up to dp x scale / 2 an
    element); the params within 2 lr a step of the exact step's (an Adam
    update moves an element by about lr)."""
    ref = single["qwen2-0.5b"]
    for res in ranks[4]:
        got = res["compressed"]["metrics"]
        assert abs(got[0]["loss"] - ref["metrics"][0]["loss"]) <= \
            LOSS_RTOL * ref["metrics"][0]["loss"]
        for g, w in zip(got, ref["metrics"]):
            assert abs(g["grad_norm"] - w["grad_norm"]) <= \
                EF_NORM_RTOL * w["grad_norm"]
        _assert_shards(res["compressed"], ref["params"], MESH_OF[4],
                       N_STEPS * 2 * ACFG["lr"], "params")


# ---------------------------------------------------------------------------
# Collectives, the compressed sum and the pipeline against the reference
# ---------------------------------------------------------------------------

def test_ef_compressed_psum_across_ranks(ranks, inputs):
    import jax
    import jax.numpy as jnp
    from repro.optim.compress import ef_compressed_psum as jef
    g = inputs["ef_g"]
    err = np.zeros_like(g)
    run = jax.vmap(lambda a, b: jef(a, b, "data"), axis_name="data")
    for rnd in range(3):
        want_tot, want_err = map(np.asarray, run(jnp.asarray(g),
                                                 jnp.asarray(err)))
        scale = np.abs(want_tot).max()
        amax = max(np.abs(g[r] + err[r]).max() for r in range(4))
        s = np.float32(max(amax, 1e-12)) / np.float32(127.0)
        for r, res in enumerate(ranks[4]):
            tot, new_err = res["ef"][rnd]
            assert np.abs(tot - want_tot[r]).max() <= EF_RTOL * scale
            assert np.abs(new_err - want_err[r]).max() <= EF_RTOL * scale
            acc = (g[r] + err[r]).astype(np.float64)
            assert np.array_equal(np.round((acc - new_err) / s),
                                  np.round((acc - want_err[r]) / s))
        err = np.stack([res["ef"][rnd][1] for res in ranks[4]])
    exact = g.sum(0)
    first = ranks[4][0]["ef"][0][0]
    assert np.abs(first - exact).max() / np.abs(exact).max() < 0.05


def test_hierarchical_psum_on_pod_by_data(ranks, inputs):
    import jax
    import jax.numpy as jnp
    from repro.parallel.collectives import hierarchical_psum as jh
    x = inputs["hier_x"]
    want = np.asarray(jax.vmap(jax.vmap(lambda v: jh(v, "data", "pod"),
                                        axis_name="data"),
                               axis_name="pod")(jnp.asarray(x)))
    for r, res in enumerate(ranks[4]):
        assert np.array_equal(res["hier"], want[r // 2, r % 2])
        assert np.array_equal(res["hier"], x.sum((0, 1)))


def test_ring_matmul_and_ring_allreduce(ranks, inputs):
    import jax
    import jax.numpy as jnp
    from repro.parallel.collectives import allgather_matmul as jmm
    from repro.parallel.collectives import ring_allreduce_reference as jar
    xs, ws = inputs["mm_x"], inputs["mm_w"]
    want_mm = np.asarray(jax.vmap(lambda a, b: jmm(a, b, "tp"),
                                  axis_name="tp")(jnp.asarray(xs),
                                                  jnp.asarray(ws)))
    want_ar = np.asarray(jax.vmap(lambda a: jar(a, "tp"),
                                  axis_name="tp")(jnp.asarray(xs)))
    full = xs.reshape(16, 32) @ np.concatenate(list(ws), 1)
    for r, res in enumerate(ranks[4]):
        assert np.abs(res["ring_mm"] - want_mm[r]).max() <= MATMUL_ATOL
        assert np.abs(res["ring_mm"] - full[:, 6 * r:6 * (r + 1)]).max() \
            <= MATMUL_ATOL
        assert np.array_equal(res["ring_ar"], want_ar[r])
        # CPU tensors go over gloo as they are: nothing through host copies
        assert res["host_copies"] == {"send": 0, "recv": 0}


def test_pipeline_equals_the_unpipelined_stack(ranks, inputs):
    import jax
    import jax.numpy as jnp
    ws, x = inputs["pipe_ws"], inputs["pipe_x"]

    def block_fn(stage_ws, h):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, h, stage_ws)
        return h

    want = np.asarray(block_fn(jnp.asarray(ws), jnp.asarray(x)))
    plain = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        plain = torch.tanh(plain @ w)
    for res in ranks[4]:
        out = res["pipeline"].reshape(want.shape)
        assert np.abs(out - want).max() <= PIPE_ATOL
        assert np.abs(out - plain.numpy()).max() <= PIPE_ATOL


# ---------------------------------------------------------------------------
# The sharded checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_checkpoint_saved_at_one_mesh_restores_at_another(ranks, shape):
    saved = ranks[4][0]["saved"]
    for res in ranks[4]:
        assert res["saved"]["params"].keys() == saved["params"].keys()
        got = res["restored"][shape]
        assert got["meta"]["step"] == 1 and got["step"] == 1
        run = {"coord": got["coord"], "specs": got["specs"],
               "params": got["params"], "mu": got["mu"]}
        _assert_shards(run, saved["params"], shape, 0.0, "params")
        _assert_shards(run, saved["mu"], shape, 0.0, "mu")


def test_jax_checkpoint_restores_sharded(ranks, inputs):
    from repro_torch.convert import from_jax_params
    cfg = get_config("qwen2-0.5b", reduced=True)
    full = _np(from_jax_params(cfg, inputs["jax_params"], "cpu"))
    for res in ranks[4]:
        _assert_shards(res["jax_restored"], full, (2, 2), 0.0, "params")
