"""Batched serving engine: chunked paged prefill + continuous-batching
pooled decode — counterpart of ``repro/serve/engine.py``.

``ServeEngine(cfg, artifact)`` serves a quantized artifact
(:class:`repro_torch.quantize.QuantArtifact`, loaded from a bundle the
reference wrote or built by the port); ``ServeEngine(cfg, params,
quant=spec)`` serves raw params under a quant spec (None = fp).  The
engine owns a :class:`~repro_torch.serve.pool.PagePool` that persists
across ``generate`` calls and hands a fresh
:class:`~repro_torch.serve.scheduler.Scheduler` the three step functions.
Everything runs eagerly on ``device`` (default ``"cuda"``); the page,
chunk and verify budgets keep the reference's pow2 bucket grid, which is
what a CUDA-graph capture of the steps would be keyed on.

KV pages are fp, int8 or int4 (``kv_mode``); int4 pages take the
artifact's ``kv_calib`` section for their outlier redistribution.
``spec_mode="ngram"`` turns on self-speculative decoding: the scheduler
drafts up to ``spec_k - 1`` tokens per slot and one
``decode_verify_paged`` call scores every slot's draft block.

Observability: ``recorder=`` (a ``repro_torch.obs.trace`` recorder;
None is the no-op ``NULL_RECORDER``) and ``quality=`` (a
``repro_torch.obs.quality.QualityObserver`` that the scheduler samples
the pool into) are host-side only.  The three step calls run under
``dispatch.observation_suspended()``: the reference's steps are jitted
and never reach its activation observer, and the port's eager steps must
not either (the snapshot would differ, and every observed site would cost
a device-to-host copy).

``decode_traces`` / ``prefill_traces`` / ``verify_traces`` count what the
reference's jit counts as traces: the first step call of each bucket key
(page budget; (chunk, page); (k, page)).  Nothing is compiled here, but
that first call is exactly where a jit retraces and where a CUDA-graph
capture per bucket would be recorded; each time one grows the recorder
gets a ``COMPILE`` event, as in ``repro/serve/engine.py``.

Not ported yet: tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.convert import as_port_params
from repro_torch.core.context import QuantCtx, as_ctx
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.obs.trace import NULL_RECORDER
from repro_torch.quantize import QuantArtifact
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PagePool
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    prompt: str
    max_new_tokens: int = 32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stream: Optional[Callable[[int], None]] = None
    ttft_s: Optional[float] = None
    ttft_steps: Optional[int] = None
    ttft_prefill_tokens: Optional[int] = None
    queue_wait_steps: Optional[int] = None
    e2e_steps: Optional[int] = None


class ServeEngine:
    """Paged continuous-batching engine for a dense or MoE decoder.

    ``kv_mode`` None follows the weight path (int8 pages for quantized
    serving, fp pages otherwise); fp pages are stored in ``cache_dtype``.
    """

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 s_max: int = 512, quant=None, *,
                 kv_mode: Optional[str] = None, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 cache_dtype=torch.bfloat16, prefix_sharing: bool = True,
                 prefill_chunk: int = 32, prefill_slots: int = 2,
                 prefill_aging: float = 1.0, spec_mode: str = "off",
                 spec_k: int = 4, recorder=None, quality=None,
                 device="cuda"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"the engine serves dense and MoE decoders, not "
                             f"{cfg.family}")
        if isinstance(params, QuantArtifact):
            if quant is not None:
                raise ValueError("pass either an artifact as params or a "
                                 "quant spec, not both")
            quant, params = params, params.params
            if params is None:
                raise ValueError("artifact carries no weights to serve")
        # the artifact's KV-page calibration (int4 outlier redistribution)
        kv_calib = getattr(quant, "kv_calib", None) or None
        self.device = torch.device(device)
        self.cfg = cfg
        self.params = as_port_params(cfg, params, self.device)
        self.max_batch, self.s_max = max_batch, s_max
        self.prefix_sharing = prefix_sharing
        self.ctx = as_ctx(quant, self.device)
        if isinstance(self.ctx, QuantCtx):
            self._check_fused_buffers()
        if kv_mode is None:
            kv_mode = "int8" if isinstance(self.ctx, QuantCtx) else "fp"
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_slots < 1:
            raise ValueError(f"prefill_slots must be >= 1, got {prefill_slots}")
        if prefill_aging < 0:
            raise ValueError(f"prefill_aging must be >= 0, got {prefill_aging}")
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_slots = int(prefill_slots)
        self.prefill_aging = float(prefill_aging)
        self.pool = PagePool(cfg, max_batch, s_max, page_size=page_size,
                             n_pages=n_pages, mode=kv_mode, dtype=cache_dtype,
                             kv_calib=kv_calib, device=self.device)
        if spec_mode not in ("off", "ngram"):
            raise ValueError(f"unknown spec_mode {spec_mode!r} "
                             "(expected 'off' or 'ngram')")
        self.spec_mode = spec_mode
        self.spec_k = int(spec_k)
        self.metrics = ServeMetrics()
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.quality = quality
        self.decode_buckets = set()      # page-budget buckets seen (lifetime)
        self.prefill_buckets = set()     # (chunk, page) bucket pairs (lifetime)
        self.verify_buckets = set()      # (k, page) bucket pairs (lifetime)
        if self.recorder.enabled:
            self.recorder.set_metadata(mesh_devices=1, kv_shards=1)

    def _check_fused_buffers(self) -> None:
        """Fail here, not inside a step: a policy that routes this model's
        sites to the fused backend needs packed kernel buffers."""
        bases = ["attn_qkv", "attn_out", "mlp_up", "mlp_down"]
        if self.cfg.family == "moe":
            bases += ["moe_up", "moe_down"]
        names = [f"layer{i}/{b}" for i in range(self.cfg.n_layers)
                 for b in bases]
        wants_fused = any(c.method != "fp" and c.backend == "fused"
                          for c in map(self.ctx.policy.resolve, names))
        if wants_fused and not self.ctx.kernel_buffers:
            raise ValueError(
                "policy routes sites to the 'fused' backend but no packed "
                "kernel buffers are available — build the artifact with "
                "repro_torch.quantize.quantize_model")

    # the reference's jit-trace counters: one per bucket key first used
    @property
    def decode_traces(self) -> int:
        return len(self.decode_buckets)

    @property
    def prefill_traces(self) -> int:
        return len(self.prefill_buckets)

    @property
    def verify_traces(self) -> int:
        return len(self.verify_buckets)

    def _first_use(self, kind: str, buckets: set, key, **args) -> None:
        """Record a bucket key; a new one is a 'trace' (COMPILE event)."""
        if key in buckets:
            return
        buckets.add(key)
        if self.recorder.enabled:
            self.recorder.compile_event(kind, **args, traces=len(buckets))

    # -- scheduler plumbing ---------------------------------------------------

    @torch.no_grad()
    def _prefill_pool(self, tokens, kv, page_table, start, write_lo, write_hi):
        cb, pb = int(tokens.shape[1]), int(page_table.shape[1])
        with dispatch.observation_suspended():
            logits, kv = T.prefill_chunk_paged(
                self.cfg, self.params, tokens, kv, page_table, start,
                write_lo, write_hi, self.ctx)
        self._first_use("prefill", self.prefill_buckets, (cb, pb),
                        chunk_bucket=cb, page_bucket=pb)
        return torch.argmax(logits[:, :, : self.cfg.vocab_size], dim=-1), kv

    @torch.no_grad()
    def _decode_pool(self, tokens, kv, page_table, pos):
        pb = int(page_table.shape[1])
        with dispatch.observation_suspended():
            logits, kv = T.decode_step_paged(self.cfg, self.params, tokens,
                                             kv, page_table, pos, self.ctx)
        self._first_use("decode", self.decode_buckets, pb, page_bucket=pb)
        return torch.argmax(logits[:, -1, : self.cfg.vocab_size], dim=-1), kv

    @torch.no_grad()
    def _verify_pool(self, tokens, kv, page_table, pos, n_valid):
        kb, pb = int(tokens.shape[1]), int(page_table.shape[1])
        with dispatch.observation_suspended():
            logits, kv = T.decode_verify_paged(self.cfg, self.params, tokens,
                                               kv, page_table, pos, n_valid,
                                               self.ctx)
        self._first_use("verify", self.verify_buckets, (kb, pb),
                        k_bucket=kb, page_bucket=pb)
        return torch.argmax(logits[:, :, : self.cfg.vocab_size], dim=-1), kv

    # -- public ---------------------------------------------------------------

    def scheduler(self) -> Scheduler:
        """A fresh scheduler over this engine's (persistent) page pool."""
        return Scheduler(self.pool, self._prefill_pool, self._decode_pool,
                         self._verify_pool, metrics=ServeMetrics(),
                         prefix_sharing=self.prefix_sharing,
                         prefill_chunk=self.prefill_chunk,
                         prefill_slots=self.prefill_slots,
                         prefill_aging=self.prefill_aging,
                         spec_mode=self.spec_mode, spec_k=self.spec_k,
                         recorder=self.recorder, quality=self.quality)

    def generate(self, requests: List[Request],
                 arrivals: Optional[Sequence[int]] = None) -> List[Request]:
        """Run all requests to completion with continuous batching."""
        sched = self.scheduler()
        sched.run(requests, arrivals)
        self.metrics = sched.metrics
        return requests

    @staticmethod
    def text(req: Request) -> str:
        return tok.decode(req.out_tokens)
