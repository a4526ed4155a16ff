"""Serving metrics: throughput, TTFT, pool occupancy, fragmentation,
decode KV read traffic and prefix-sharing stats.

Counterpart of ``repro/serve/metrics.py``, with the same counter names and
``report()`` keys, so the port's counters compare one to one with the
reference engine's.  :class:`ServeMetrics` is a facade over a
:class:`repro_torch.obs.registry.MetricsRegistry`: attribute reads and
writes on the counter/gauge names route to the registry, latency
distributions accumulate in fixed-bucket histograms, and
``registry.snapshot()`` dumps the whole metric surface.

``kv_bytes_read`` is what the bucketed page-budget reads actually read;
``kv_bytes_read_dense`` is what a full-capacity read (``pages_per_slot``
pages per slot per step) would have read for the same steps.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.obs.registry import COUNT_BUCKETS, STEP_BUCKETS, MetricsRegistry

# scalar int counters the facade routes to registry Counters (attribute
# name == registry name; report() reads them back by the same names)
_COUNTERS = (
    "tokens_out",          # generated tokens (prefill-sampled + decode)
    "decode_steps",        # pooled decode step invocations
    "decode_slot_steps",   # sum of active slots over decode steps
    "prefills",            # prompts fully prefilled (chunked)
    "prefill_chunks",      # per-slot chunks advanced (N slots in one traced
                           # call count N — the pre-multi-slot meaning)
    "prefill_chunk_tokens",  # valid prompt tokens prefilled via chunks
    "prefill_steps",       # traced multi-slot prefill invocations (<= chunks)
    "prefill_computed_tokens",  # rows x chunk bucket over prefill calls:
                                # the token positions the model computed
    "prefill_multi_steps",  # prefill steps advancing >= 2 slots at once
    "prefill_resumes",     # mid-prefill preemptions resumed from the true
                           # chunk boundary (kept pages, zero chunks re-run)
    "prefill_wait_steps_max",  # worst step-clock age a prompt reached while
                               # still prefilling — the anti-starvation
                               # bound the aging term exists to cap
    "interleaved_steps",   # steps running a prefill chunk AND decode
    "decode_stall_steps",  # steps where live decode slots got no decode
    # self-speculative decoding (all deterministic: argmax verify)
    "spec_verify_steps",   # pooled steps that ran the k-token verify
    "spec_proposed",       # draft tokens proposed (n-gram lookup hits)
    "spec_accepted",       # draft tokens the verify argmax reproduced
    "decode_steps_saved",  # slot-steps speculation avoided (= accepted)
    "preemptions",
    "submitted",
    "completed",
    "cache_bytes",
    "cache_bytes_per_shard",  # ONE mesh shard's pool bytes (== cache_bytes
                              # single-device); cache_bytes stays GLOBAL
                              # under a mesh so the byte series
                              # never silently become per-shard
    "live_slots_peak",     # most slots concurrently admitted in a step
    # block-sparse decode read accounting
    "kv_bytes_read",       # bucketed page-budget gather (actual)
    "kv_bytes_read_dense",  # full-capacity gather (counterfactual)
    # prefix sharing
    "prefix_hits",         # admissions that mapped shared pages
    "shared_pages_mapped",  # pages mapped instead of allocated
    "pages_shared_peak",   # peak pages with refcount > 1
    "cow_copies",          # copy-on-write page copies THIS run
    "cow_baseline",        # pool-lifetime cow count at run start
)
_GAUGES = (
    "bytes_per_token",     # page bytes per token position, all layers
    "kv_shards",           # mesh shards the KV pages split over (1 = no
                           # mesh / replicated GQA fallback)
)
_ROUTED = frozenset(_COUNTERS + _GAUGES)

# histogram name -> bucket edges (all step-clock / small-count quantities)
_HISTOGRAMS = (
    ("hist/ttft_steps", STEP_BUCKETS),
    ("hist/queue_wait_steps", STEP_BUCKETS),
    ("hist/e2e_steps", STEP_BUCKETS),
    ("hist/accepted_draft_len", COUNT_BUCKETS),
    ("hist/request_decode_steps", COUNT_BUCKETS),
)


class ServeMetrics:
    """Registry-backed serving metrics facade (see module docstring)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        d = self.__dict__
        d["registry"] = registry if registry is not None else MetricsRegistry()
        for name in _COUNTERS:
            self.registry.counter(name)
        for name in _GAUGES:
            self.registry.gauge(name)
        for name, buckets in _HISTOGRAMS:
            self.registry.histogram(name, buckets)
        # non-scalar state stays plain attrs (lists feed means/maxes the
        # report has always exposed; the histograms carry the percentiles)
        d["ttft_s"] = []
        d["ttft_steps"] = []
        d["occupancy"] = []
        d["fragmentation"] = []
        d["decode_buckets"] = {}
        d["kv_mode"] = ""            # pool page mode ("fp"/"int8"/"int4")
        d["_t0"] = None
        d["_t1"] = None

    # -- the facade: scalar metric names route to the registry ---------------

    def __getattr__(self, name):
        # only reached when ``name`` is not an instance attribute
        if name in _ROUTED:
            return self.__dict__["registry"].value(name)
        raise AttributeError(name)

    def __setattr__(self, name, value) -> None:
        if name in _ROUTED:
            self.__dict__["registry"].set_value(name, value)
        else:
            self.__dict__[name] = value

    def observe(self, hist: str, x) -> None:
        """Record one observation into histogram ``hist/<hist>``."""
        self.registry.histogram(f"hist/{hist}").observe(x)

    def percentile(self, hist: str, q: float) -> float:
        return self.registry.histogram(f"hist/{hist}").percentile(q)

    # -- run clock -----------------------------------------------------------

    def start(self) -> float:
        self._t0 = time.perf_counter()
        return self._t0

    def stop(self) -> None:
        self._t1 = time.perf_counter()

    @property
    def elapsed_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return (self._t1 or time.perf_counter()) - self._t0

    # -- update hooks --------------------------------------------------------

    def record_read(self, pool, bucket: int) -> None:
        """Account one pooled decode step's KV page reads: ``bucket`` pages
        per slot actually gathered vs the dense ``pages_per_slot``."""
        per_page = pool.page_read_bytes()
        self.kv_bytes_read += pool.n_slots * bucket * per_page
        self.kv_bytes_read_dense += pool.n_slots * pool.pages_per_slot * per_page
        self.decode_buckets[bucket] = self.decode_buckets.get(bucket, 0) + 1

    def sample_pool(self, pool_stats: Dict[str, float]) -> None:
        self.occupancy.append(float(pool_stats.get("occupancy", 0.0)))
        frag = pool_stats.get("internal_fragmentation")
        if frag is not None:
            self.fragmentation.append(float(frag))
        self.cache_bytes = int(pool_stats.get("cache_bytes", self.cache_bytes))
        self.cache_bytes_per_shard = int(pool_stats.get(
            "cache_bytes_per_shard", self.cache_bytes_per_shard))
        self.kv_shards = float(pool_stats.get("kv_shards", self.kv_shards))
        self.kv_mode = str(pool_stats.get("kv_mode", self.kv_mode))
        self.bytes_per_token = float(
            pool_stats.get("bytes_per_token", self.bytes_per_token))
        self.pages_shared_peak = max(
            self.pages_shared_peak, int(pool_stats.get("pages_shared", 0)))
        # pool counters are lifetime (the pool outlives each generate());
        # subtract the run-start baseline so the report stays per-run
        if "cow_count" in pool_stats:
            self.cow_copies = int(pool_stats["cow_count"]) - self.cow_baseline

    @staticmethod
    def _mean(xs: List[float]) -> float:
        return sum(xs) / len(xs) if xs else 0.0

    def report(self) -> Dict[str, float]:
        dt = self.elapsed_s
        return {
            "tokens_out": self.tokens_out,
            "tokens_per_sec": self.tokens_out / dt if dt else 0.0,
            "decode_steps": self.decode_steps,
            "decode_batch_mean": (self.decode_slot_steps / self.decode_steps
                                  if self.decode_steps else 0.0),
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "prefill_chunks_per_prompt": (self.prefill_chunks / self.prefills
                                          if self.prefills else 0.0),
            # multi-slot prefill: batching shape, true-resume count and
            # the starvation face the aging bounds
            "prefill_steps": self.prefill_steps,
            "prefill_multi_steps": self.prefill_multi_steps,
            "prefill_batch_mean": (self.prefill_chunks / self.prefill_steps
                                   if self.prefill_steps else 0.0),
            # share of the computed prefill positions that carried a token
            "prefill_computed_tokens": self.prefill_computed_tokens,
            "prefill_row_use": (self.prefill_chunk_tokens
                                / self.prefill_computed_tokens
                                if self.prefill_computed_tokens else 0.0),
            "prefill_resumes": self.prefill_resumes,
            "prefill_wait_steps_max": self.prefill_wait_steps_max,
            "interleaved_steps": self.interleaved_steps,
            "decode_stall_steps": self.decode_stall_steps,
            "spec_verify_steps": self.spec_verify_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "decode_steps_saved": self.decode_steps_saved,
            "preemptions": self.preemptions,
            "submitted": self.submitted,
            "completed": self.completed,
            "ttft_ms_mean": 1e3 * self._mean(self.ttft_s),
            "ttft_ms_max": 1e3 * max(self.ttft_s) if self.ttft_s else 0.0,
            "ttft_steps_mean": self._mean(self.ttft_steps),
            "ttft_steps_max": max(self.ttft_steps) if self.ttft_steps else 0,
            # tail latency via the bucket histograms
            "ttft_steps_p50": self.percentile("ttft_steps", 0.50),
            "ttft_steps_p95": self.percentile("ttft_steps", 0.95),
            "queue_wait_steps_p50": self.percentile("queue_wait_steps", 0.50),
            "queue_wait_steps_p95": self.percentile("queue_wait_steps", 0.95),
            "e2e_steps_p50": self.percentile("e2e_steps", 0.50),
            "e2e_steps_p95": self.percentile("e2e_steps", 0.95),
            "pool_occupancy_mean": self._mean(self.occupancy),
            "pool_occupancy_peak": max(self.occupancy) if self.occupancy else 0.0,
            "fragmentation_mean": self._mean(self.fragmentation),
            "cache_bytes": self.cache_bytes,
            # tensor-parallel serving: global vs
            # ONE-shard pool bytes + the shard count itself
            "cache_bytes_per_shard": self.cache_bytes_per_shard,
            "kv_shards": self.kv_shards,
            "live_slots_peak": self.live_slots_peak,
            "kv_mode": self.kv_mode,
            "bytes_per_token": self.bytes_per_token,
            "kv_bytes_read": self.kv_bytes_read,
            "kv_bytes_read_dense": self.kv_bytes_read_dense,
            "kv_read_savings": (1.0 - self.kv_bytes_read / self.kv_bytes_read_dense
                                if self.kv_bytes_read_dense else 0.0),
            "decode_buckets": {str(k): v for k, v in
                               sorted(self.decode_buckets.items())},
            "prefix_hits": self.prefix_hits,
            "shared_pages_mapped": self.shared_pages_mapped,
            "pages_shared_peak": self.pages_shared_peak,
            "cow_copies": self.cow_copies,
            "elapsed_s": dt,
        }
