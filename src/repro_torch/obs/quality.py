"""Quant-quality observers: calibration drift made visible on live traffic.

Counterpart of ``repro/obs/quality.py``.  MUXQ's calibration batches pick
the outlier channels and the masks freeze into the artifact; nothing else
checks whether live traffic still looks like the calibration set.  This
module gives the two quantization seams an opt-in observer:

  * **activation seam** (``QuantCtx``/dispatch): an *eager* quantized
    matmul reports its input to :meth:`QualityObserver.observe_activation`
    — per-site activation amax, the saturation rate at the act-quant
    ``±qmax`` (the fraction of quantized values pinned to the endpoints:
    per-token abs-max scaling never clips, so a high rate means a
    heavy-tailed token poorly served by one scale), and the hit-rate of
    the channels that look like outliers NOW against the calibrated static
    mask.  Installed via ``repro_torch.kernels.dispatch.
    set_quality_observer``.  The serving engine runs its three step calls
    under ``dispatch.observation_suspended()``, as the reference's jitted
    steps never observe: the serve loop stays observation-free and pays no
    device-to-host copy.

  * **KV seam** (pool pages): observed host-side between scheduler steps
    — :meth:`QualityObserver.sample_pool` copies the live pages of an
    int8/int4 pool to the host (only those pages), counts saturation at
    the mode's ``±qmax`` (int4's redistribution exists to keep outlier
    channels from pinning whole heads to ±7), and compares the currently
    hot channels (per-head page amax) against the calibrated int4 outlier
    mask (``k_redist > 1``).  A falling hit-rate is the drift signal:
    traffic's outliers are no longer the calibration's outliers.

Everything accumulates in plain host-side numpy, in the reference's
arithmetic; ``snapshot()`` folds it into a JSON-able dict for
``launch/serve.py --json-out`` and tests.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

DEFAULT_OUTLIER_RATIO = 4.0     # channel amax > ratio * median => "hot now"
_FLOOR = 1e-6


def _host(a) -> np.ndarray:
    """A tensor (on any device; bf16 widened to f32) or array as numpy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.detach().cpu().numpy()
    return np.asarray(a)


class SiteQuality:
    """One observation site's accumulated stats."""

    __slots__ = ("calls", "elements", "amax", "saturated",
                 "hot_channels", "hot_hits")

    def __init__(self):
        self.calls = 0
        self.elements = 0
        self.amax = 0.0
        self.saturated = 0          # quantized values pinned at +/-qmax
        self.hot_channels = 0       # channels that look like outliers now
        self.hot_hits = 0           # ... of those, inside the calibrated mask

    @property
    def clip_rate(self) -> float:
        return self.saturated / self.elements if self.elements else 0.0

    @property
    def outlier_hit_rate(self) -> float:
        return (self.hot_hits / self.hot_channels
                if self.hot_channels else 1.0)

    def snapshot(self) -> Dict[str, float]:
        return {"calls": self.calls, "elements": self.elements,
                "amax": self.amax, "clip_rate": self.clip_rate,
                "hot_channels": self.hot_channels,
                "outlier_hit_rate": self.outlier_hit_rate}


def _hot_mask(ch_amax: np.ndarray, ratio: float) -> np.ndarray:
    """Channels that look like outliers in THIS observation: amax above
    ``ratio`` times the median channel amax (the relative criterion that
    calibration uses)."""
    med = max(float(np.median(ch_amax)), _FLOOR)
    return ch_amax > ratio * med


class QualityObserver:
    """Accumulates per-site activation stats and KV-page stats (see module
    docstring).  One instance rides a launcher run; install on the
    activation seam with ``dispatch.set_quality_observer(obs)`` and pass
    to ``ServeEngine(..., quality=obs)`` for the KV seam."""

    def __init__(self, *, ratio: float = DEFAULT_OUTLIER_RATIO,
                 sample_every: int = 8):
        self.ratio = float(ratio)
        # pool pages copy device->host: sample every Nth scheduler step
        self.sample_every = max(1, int(sample_every))
        self.sites: Dict[str, SiteQuality] = {}
        self.pool_samples = 0

    def _site(self, name: str) -> SiteQuality:
        s = self.sites.get(name)
        if s is None:
            s = self.sites[name] = SiteQuality()
        return s

    # -- activation seam (eager QuantCtx calls only) -------------------------

    def observe_activation(self, name: str, x, *, qmax: int,
                           mask: Optional[np.ndarray] = None) -> None:
        """One eager quantized matmul's input ``x`` [..., ch] (a tensor or
        an array) at site ``name``.  ``qmax`` is the act-quant integer
        ceiling (127 for int8); ``mask`` the site's calibrated static
        outlier mask, if any."""
        x = _host(x)
        x = np.abs(x.astype(np.float32)).reshape(-1, x.shape[-1])
        st = self._site(name)
        st.calls += 1
        st.elements += x.size
        st.amax = max(st.amax, float(x.max()) if x.size else 0.0)
        # per-token abs-max scaling: a value saturates iff it IS the row max
        scale = np.maximum(x.max(axis=-1, keepdims=True), _FLOOR) / qmax
        st.saturated += int((np.round(x / scale) >= qmax).sum())
        ch_amax = x.max(axis=0)
        hot = _hot_mask(ch_amax, self.ratio)
        st.hot_channels += int(hot.sum())
        if mask is not None:
            st.hot_hits += int((hot & _host(mask).astype(bool)).sum())
        else:
            st.hot_hits += int(hot.sum())   # no mask: vacuously all hits

    # -- KV seam (host-side pool page sampling) ------------------------------

    def maybe_sample_pool(self, pool, step: int) -> None:
        """Scheduler hook: sample every ``sample_every``-th step."""
        if step % self.sample_every == 0:
            self.sample_pool(pool)

    def sample_pool(self, pool) -> None:
        """Snapshot a :class:`repro_torch.serve.pool.PagePool`'s live
        quantized pages: saturation at the mode's ``±qmax`` and — int4 —
        hot channels vs the calibrated redistribution mask.  Only the live
        pages leave the device."""
        qmax = getattr(pool.quantizer, "qmax", None)
        if qmax is None:
            return                          # fp pages: nothing quantized
        live = pool.live_pages()
        if live.size == 0:
            return
        self.pool_samples += 1
        idx = torch.as_tensor(live, dtype=torch.long, device=pool.device)
        for side in ("k", "v"):
            # [L, pages, ps, kvh, dh(/2)] int8 -> live pages only
            q = pool.kv[side][:, idx]
            if pool.mode == "int4":
                from repro_torch.serve.kvq import unpack_int4
                q = unpack_int4(q)
            q = _host(q)
            st = self._site(f"kv/{side}")
            st.calls += 1
            st.elements += q.size
            st.saturated += int((np.abs(q) >= qmax).sum())
            # the channel criterion runs on dequantized magnitudes, so the
            # calibrated 2^e redistribution (which exists to DE-hot the
            # outliers in the stored ints) does not hide them
            sc = pool.kv.get(f"{side}_scale")
            scale = (_host(sc[:, idx].float()) if sc is not None
                     else np.float32(1.0))
            deq = np.abs(q.astype(np.float32)) * scale
            redist = pool.kv.get(f"{side}_redist")
            if redist is not None:
                r = _host(redist.float())                # [L, kvh, dh]
                deq = deq * r[:, None, None]
                mask = (r > 1.0).any(axis=0)            # [kvh, dh]
            else:
                mask = None
            ch_amax = deq.max(axis=(0, 1, 2))           # [kvh, dh]
            st.amax = max(st.amax, float(ch_amax.max()))
            hot = _hot_mask(ch_amax.reshape(-1), self.ratio).reshape(
                ch_amax.shape)
            st.hot_channels += int(hot.sum())
            st.hot_hits += int((hot & mask).sum() if mask is not None
                               else hot.sum())

    # -- consumption ---------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        return {"pool_samples": self.pool_samples,
                "sites": {name: s.snapshot()
                          for name, s in sorted(self.sites.items())}}
