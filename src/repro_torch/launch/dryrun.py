"""Dry-run: trace every (arch x shape x mesh) cell's per-rank program and
record its cost, memory and collectives for the roofline report —
counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape decode_32k --mesh pod --no-save

**The world.**  The reference lowers for 512 placeholder devices.  Here
:func:`fake_world` opens a ``torch.distributed`` process group of 256
(one pod, a (16, 16) mesh) or 512 ranks (two pods, (2, 16, 16)) on the
"fake" backend, this process its rank 0, inside :func:`run_cell` and
closed after it.  A collective on it returns at once and moves nothing;
the program runs on ``meta`` tensors, so nothing is computed or
allocated either: the trace is the program rank 0 runs, at full width
and depth.

**The per-rank program** is what the port runs on a rank today:

* train cells: ``parallel.spmd.make_sharded_train_step``, params and the
  AdamW moments (f32) sharded by ``param_specs``;
* prefill and decode cells: ``launch.steps.make_prefill_step`` /
  ``make_serve_step`` on the rank's ``batch_specs`` rows, with
  ``set_activation_sharding``, ``set_cache_update_mode`` and
  ``set_expert_sharding`` set as the reference sets them.  The quant
  ``muxq`` serves a fused MUXQ artifact (``MUXQ_FUSED_SERVE``) on
  ``specs.synthetic_qparams``'s masks: every site through
  ``rowwise_quantize`` + ``muxq_gemm`` on packed buffers
  (``dispatch.abstract_site_buffer``), the raw site weights replaced by
  inert stubs, as the ``fused`` pack target keeps them; ``fp`` serves
  the bf16 params.

Where the port's program differs from the reference's GSPMD one, the
numbers show it: every param is gathered in full at the start of a train
step (ROADMAP Queue 2 M), there is no tensor-parallel compute along
"model" (Queue 2 N: ranks that differ only there repeat each other's
work, and a decode rank holds every KV head of its rows, not the
``cache_specs`` head shard), and the serve steps hold the whole params.
Both show in ``useful_fraction`` and in ``memory``.

**A record** keeps the reference's keys: ``cost`` ("flops", "bytes
accessed", and "int8 ops" of the flops) from ``analysis.hlo.CostCounter``
over the traced step, the kernel sites counted from their shapes;
``memory`` (``CostCounter.memory``); ``collectives`` / ``coll_counts``
from the transport's records (``collectives.recording``); ``roofline``
from ``analysis.roofline.make_roofline`` with the int8 share of the
counted flops.  The reference's ``_combine`` has no counterpart: XLA
counts a scan body once, the port has no scan and traces every layer, so
``corrected`` stays False (``correct`` is taken and ignored).
``compile_s`` becomes ``trace_s``, the wall seconds of the traced step.
Records go to ``chiprun_out/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import hlo as hlo_mod
from repro_torch.analysis import roofline as R
from repro_torch.configs import get_config, list_archs
from repro_torch.core.policy import SitePolicy
from repro_torch.kernels import dispatch
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.act_sharding import (set_activation_sharding,
                                               set_cache_update_mode)
from repro_torch.parallel.spmd import make_sharded_train_step
from repro_torch.quantize import (QuantArtifact, build_artifact, fused_sites,
                                  stub_weights)

OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun"

QUANTS = ("fp", "muxq")


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for
    the block (no other group may be open)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run opens its own fake world: destroy "
                           "the open process group first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The per-rank programs
# ---------------------------------------------------------------------------

def _floats_to(tree, dtype):
    return adamw.tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                          else t, tree)


def _rank_rows(mesh, global_batch: int) -> int:
    """The batch rows a rank holds under ``batch_specs``."""
    spec = SH.fit_spec(mesh, (global_batch,), [SH.dp_axes(mesh)])
    return SH.shard_shape((global_batch,), spec, mesh)[0]


def _materialize(tree, device, gen: torch.Generator):
    """A meta tree on ``device``: floats from a seeded normal, integers
    zero (the caller sets what must differ)."""
    def one(t):
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen).to(device, t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return {k: one(v) for k, v in tree.items()}


def fused_artifact(cfg, params, masks: Dict[str, np.ndarray],
                   device) -> QuantArtifact:
    """The served MUXQ artifact of the dry-run's ``muxq`` cells:
    ``MUXQ_FUSED_SERVE`` on every site, packed from ``masks`` (a site
    without one packs with no outlier channel).  On the meta device the
    buffers are :func:`dispatch.abstract_site_buffer`'s; elsewhere
    ``quantize.build_artifact`` packs the real weights.  Either way the
    buffers are tensors on ``device`` as the ctx keeps them."""
    policy = SitePolicy.uniform(ST.MUXQ_FUSED_SERVE)
    if torch.device(device).type == "meta":
        art = QuantArtifact(policy=policy, masks=dict(masks))
        for site, _, w in fused_sites(cfg, params, policy):
            n_out = int(masks[site].sum()) if site in masks else 0
            art.kernel_buffers[site] = dispatch.abstract_site_buffer(
                tuple(w.shape), n_out, device=device)
    else:
        art = build_artifact(cfg, params, policy, masks)
        art.params = None
    art.kernel_buffers = {s: dispatch.buffer_to(b, device)
                          for s, b in art.kernel_buffers.items()}
    return art


def serve_program(cfg, shape, mesh, quant: str, device="meta", seed: int = 0):
    """(step, (params, batch), held, tokens) of a prefill or decode cell's
    rank: ``held`` is the state the step reads beside its arguments (the
    artifact's buffers).  On a real device the params come from
    ``init_params(seed)``, activations and caches from a seeded normal,
    tokens from a seeded uniform; the decode cache's ``pos`` is its last
    position, so the step attends over the whole cache."""
    if quant not in QUANTS:
        raise ValueError(f"unknown quant {quant!r} (one of {QUANTS})")
    dev = torch.device(device)
    real = dev.type != "meta"
    gen = torch.Generator().manual_seed(seed)
    params = _floats_to(T.init_params(cfg, seed=seed, device=dev),
                        torch.bfloat16)
    art, held = None, {}
    if quant != "fp":
        masks = SP.eager_masks(cfg, SP.synthetic_qparams(cfg))
        art = fused_artifact(cfg, params, masks, dev)
        params = stub_weights(params, fused_sites(cfg, params, art.policy))
        held = art.kernel_buffers
    b = _rank_rows(mesh, shape.global_batch)
    if shape.mode == "prefill":
        batch = {k: torch.empty((b,) + tuple(v.shape[1:]), dtype=v.dtype,
                                device="meta")
                 for k, v in SP.prefill_specs_abstract(cfg, shape).items()}
        step = ST.make_prefill_step(cfg, shape.seq_len, quant=art,
                                    device=dev)
        tokens = shape.global_batch * shape.seq_len
    else:
        batch = {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                       device="meta"),
                 "cache": SP.cache_abstract(cfg, shape, batch=b)}
        step = ST.make_serve_step(cfg, quant=art, device=dev)
        tokens = shape.global_batch
    if real:
        cache = batch.pop("cache", None)
        batch = _materialize(batch, dev, gen)
        batch["tokens"] = torch.randint(0, cfg.vocab_size,
                                        tuple(batch["tokens"].shape),
                                        generator=gen).to(dev, torch.int32)
        if cache is not None:
            batch["cache"] = _materialize(cache, dev, gen)
            batch["cache"]["pos"].fill_(shape.seq_len - 1)
    return step, (params, batch), held, tokens


def train_program(cfg, shape, mesh, quant: str, *, fsdp: bool = True):
    """(step, (params, opt_state, batch), tokens) of a train cell's rank:
    the sharded step on meta DTensor shards."""
    if quant != "fp":
        raise ValueError(f"train cells run fp (the sharded step trains the "
                         f"f32 params), not {quant!r}")
    params = T.init_params(cfg, device="meta")
    specs = SH.param_specs(cfg, params, mesh, fsdp=fsdp)
    state = adamw.init_state(params)
    opt = {"mu": SH.distribute(state["mu"], specs, mesh),
           "nu": SH.distribute(state["nu"], specs, mesh),
           "step": state["step"]}
    dparams = SH.distribute(params, specs, mesh)
    del params, state
    step = make_sharded_train_step(cfg, mesh, specs, device="meta")
    batch = SP.batch_specs_abstract(cfg, shape)
    return step, (dparams, opt, batch), shape.global_batch * shape.seq_len


def _set_sharding(cfg, shape, mesh, seq_shard: bool) -> None:
    sizes = SH.mesh_shape(mesh)
    set_activation_sharding(SH.activation_spec(mesh, seq_shard=seq_shard)
                            if shape.mode != "decode" else None)
    set_cache_update_mode(
        "select" if cfg.n_kv_heads % sizes["model"] else "dus")
    if cfg.n_experts:
        dp = SH.dp_axes(mesh)
        moe_mod.set_expert_sharding(
            lambda shp: SH.fit_spec(mesh, shp, (dp, "model", None, None)))
    else:
        moe_mod.set_expert_sharding(None)


def _reset_sharding() -> None:
    set_activation_sharding(None)
    set_cache_update_mode("dus")
    moe_mod.set_expert_sharding(None)


def trace(step, args, held=None) -> dict:
    """Run ``step(*args)`` under a :class:`hlo.CostCounter` and the
    transport's recorder: the counts, the memory, the collectives and
    the trace's wall seconds."""
    counter = hlo_mod.CostCounter()
    counter.arguments(args, held or {})
    t0 = time.time()
    with C.recording() as records, counter:
        out = step(*args)
    trace_s = time.time() - t0
    counter.outputs(out)
    return {"cost": counter.cost(), "mem": counter.memory(),
            "coll": hlo_mod.collective_bytes(records),
            "kernels": counter.kernels, "ops": counter.ops,
            "op_bytes": counter.op_bytes,
            "trace_s": trace_s}


def _compile_costs(cfg, shape, mesh, quant, *, fsdp, seq_shard) -> dict:
    """Trace one cell's per-rank program on ``mesh`` (a world must be
    open): the reference's lower + compile + analyses."""
    _set_sharding(cfg, shape, mesh, seq_shard)
    try:
        if shape.mode == "train":
            step, args, tokens = train_program(cfg, shape, mesh, quant,
                                               fsdp=fsdp)
            held = None
        else:
            step, args, held, tokens = serve_program(cfg, shape, mesh, quant)
        out = trace(step, args, held)
    finally:
        _reset_sharding()
    out["tokens"] = tokens
    return out


def lower_paged_cell(arch: str, tp: int, *, kv_mode: str = "int8",
                     max_batch: int = 2, s_max: int = 128,
                     page_size: int = 16) -> dict:
    """Prove a production config runs through the TENSOR-PARALLEL paged
    serving path: in a fake world of ``tp`` ranks, build the port's
    ``ServeEngine`` (and its ``PagePool``, sharded by KV head) at ``tp``
    with bf16 params on the meta device, run one pooled decode of this
    rank's shard on meta tensors, and report global vs per-shard pool
    bytes (per-shard = global / tp when the config's kvh divides).
    ``lowered`` means that decode ran."""
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch).replace(dtype="bfloat16")
    with fake_world(tp):
        params = _floats_to(T.init_params(cfg, device="meta"),
                            torch.bfloat16)
        eng = ServeEngine(cfg, params, max_batch=max_batch, s_max=s_max,
                          kv_mode=kv_mode, page_size=page_size, tp=tp,
                          device="meta")
        pool = eng.pool
        bucket = pool.bucket_pages(pool.pages_per_slot)
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
        nxt, _ = eng._decode_pool(z(max_batch, 1), pool.state(),
                                  z(max_batch, bucket), z(max_batch))
        return {"arch": arch, "tp": tp, "kv_mode": kv_mode,
                "n_kv_heads": cfg.n_kv_heads,
                "heads_sharded": pool.heads_sharded,
                "kv_shards": pool.kv_shards,
                "cache_bytes": pool.cache_bytes(),
                "cache_bytes_per_shard": pool.cache_bytes_per_shard(),
                "lowered": tuple(nxt.shape) == (max_batch,)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, quant: str,
             seq_shard: bool = None, fsdp: bool = True,
             save: bool = True, tag: str = "", correct: bool = None) -> dict:
    t0 = time.time()
    cfg = get_config(arch).replace(dtype="bfloat16", remat=True)
    shape = SP.SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mode": shape.mode,
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
           "quant": quant, "fsdp": fsdp, "status": "?", "tag": tag}

    ok, why = SP.cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, save)
        return rec

    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            # sequence parallelism: on for training where the sequence
            # divides "model", off for decode (seq dim = 1)
            if seq_shard is None:
                seq_shard = (shape.mode == "train"
                             and shape.seq_len % SH.mesh_shape(mesh)["model"] == 0)
            full = _compile_costs(cfg, shape, mesh, quant, fsdp=fsdp,
                                  seq_shard=seq_shard)
        cost, coll = full["cost"], full["coll"]
        int8_frac = cost["int8 ops"] / cost["flops"] if cost["flops"] else 0.0
        roof = R.make_roofline(cost, coll, cfg, full["tokens"], shape.mode,
                               chips, int8_fraction=int8_frac)
        rec.update(status="ok", seq_shard=bool(seq_shard), corrected=False,
                   trace_s=round(full["trace_s"], 2),
                   total_s=round(time.time() - t0, 1),
                   cost=cost, memory=full["mem"],
                   collectives={k: v for k, v in coll.items()
                                if k != "counts"},
                   coll_counts=coll["counts"], kernels=full["kernels"],
                   op_histogram=hlo_mod.op_histogram(full["ops"]),
                   op_bytes=hlo_mod.op_histogram(full["op_bytes"]),
                   roofline=roof.as_dict())
    except Exception as e:  # record the failure: dry-run bugs are OUR bugs
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _save(rec, save)
    return rec


def _save(rec: dict, save: bool):
    if not save:
        return
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    name = (f"{rec['arch']}_{rec['shape']}_{rec['mesh'].replace('x', '-')}"
            f"_{rec['quant']}{tag}.json")
    (OUT_DIR / name).write_text(json.dumps(rec, indent=1, default=str))


def summary(rec: dict) -> str:
    """One line of a record: for an ok cell the roofline terms (arithmetic
    on the H100 constants of ``analysis.roofline``, not a measurement),
    the rank's argument and peak bytes and its collective bytes."""
    head = (f"[{rec['status']:7s}] {rec['arch']:24s} {rec['shape']:12s} "
            f"{rec['mesh']:8s} {rec['quant']:8s}")
    if rec["status"] == "error":
        return f"{head} {rec['error'][:160]}"
    if rec["status"] != "ok":
        return f"{head} {rec.get('reason', '')}"
    r, m = rec["roofline"], rec["memory"]
    return (f"{head} dom={r['dominant']} step={r['step_s']:.3e}s "
            f"mfu_bound={r['mfu_bound']:.4f} "
            f"args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
            f"peak={m['peak_size_in_bytes'] / 2**30:.2f}GiB "
            f"coll={rec['collectives']['total'] / 2**30:.3f}GiB "
            f"trace={rec['trace_s']:.1f}s  (roofline arithmetic on H100 "
            "constants, not a measurement)")


def resolve_quant(quant: str, shape_name: str) -> str:
    """``auto``: fp for train cells, muxq for the serve cells."""
    if quant != "auto":
        return quant
    return "fp" if SP.SHAPES[shape_name].mode == "train" else "muxq"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all", *SP.SHAPES])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--quant", default="auto",
                    help="auto(=muxq for serve, fp for train)|fp|muxq")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SP.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    n_bad = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                quant = resolve_quant(args.quant, shape)
                if args.resume:
                    mesh_s = "2-16-16" if mp else "16-16"
                    tag = f"_{args.tag}" if args.tag else ""
                    f = OUT_DIR / f"{arch}_{shape}_{mesh_s}_{quant}{tag}.json"
                    if (f.exists() and json.loads(f.read_text()).get("status")
                            in ("ok", "skipped")):
                        print(f"[cached ] {arch:24s} {shape:12s}", flush=True)
                        continue
                rec = run_cell(arch, shape, multi_pod=mp, quant=quant,
                               save=not args.no_save, tag=args.tag)
                n_bad += rec["status"] == "error"
                print(summary(rec), flush=True)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
