"""Observability: serve-stack tracing, metrics registry, quality observers
(counterpart of ``repro/obs``).

  * :mod:`repro_torch.obs.trace`    — ring-buffered request/step flight
    recorder with Chrome-trace/Perfetto export (zero-cost when off);
  * :mod:`repro_torch.obs.registry` — named counters / gauges /
    fixed-bucket histograms with one ``snapshot()`` (``ServeMetrics``
    rides one);
  * :mod:`repro_torch.obs.quality`  — opt-in quant-quality observers on
    the activation (``QuantCtx``/dispatch) and KV (pool page) seams.
"""
from repro_torch.obs.registry import (COUNT_BUCKETS, STEP_BUCKETS, Counter,
                                      Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NULL_RECORDER, NullRecorder, TraceRecorder,
                                   chrome_errors, lifecycle_errors)
from repro_torch.obs.quality import QualityObserver

__all__ = [
    "COUNT_BUCKETS", "STEP_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_RECORDER", "NullRecorder", "TraceRecorder",
    "chrome_errors", "lifecycle_errors", "QualityObserver",
]
