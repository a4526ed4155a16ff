"""``QuantArtifact``: everything quantized serving needs, in one object.

Counterpart of ``repro/quantize.py``.  :meth:`QuantArtifact.load` reads
the reference's bundle format (v1..v3, ``docs/ARTIFACT_FORMAT.md``: one
npz per group plus ``meta.json``), so the port serves bundles the JAX
package wrote.  :func:`pack_kernel_buffers` packs a fused-backend policy's
per-site kernel buffers from the port's own params and calibrated masks,
mirroring the reference's ``_pack_kernel_buffers``, so the port can also
build an artifact without JAX.  :func:`calibrate_model` is the
reference's calibration pass (``_run_calibration``): a ``CollectCtx``
over the eager dense ``forward``, with a ``KVCalibCollector`` installed
as the KV observer, so one set of forwards yields the matmul-site stats
and the int4 KV pages' ``kv_calib``.  ``quantize_model`` and ``save`` are
a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.calibrate import calibrate
from repro_torch.core.outliers import CalibrationStats
from repro_torch.core.policy import SitePolicy, as_policy
from repro_torch.kernels import dispatch

_FORMAT_VERSION = 3
_GROUPS = ("masks", "act_absmax", "smooth_factors", "scan_qparams",
           "kernel_buffers", "params", "kv_calib")
_SMOOTH_METHODS = ("smoothquant", "muxq_smooth")

# ctx site base name -> weight leaf inside one layer's params (dense family)
SITE_WEIGHT_PATH = {
    "attn_qkv": ("attn", "wqkv"), "attn_out": ("attn", "wo"),
    "mlp_up": ("mlp", "wi"), "mlp_down": ("mlp", "wo"),
}


def _unflatten_nested(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """'{key}#{field}' npz keys -> one level of dict nesting."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        if "#" in key:
            base, field = key.rsplit("#", 1)
            out.setdefault(base, {})[field] = val
        else:
            out[key] = val
    return out


@dataclasses.dataclass
class QuantArtifact:
    """Policy, calibrated state and packed kernel buffers.

    ``kernel_buffers`` is {eager site: {field: array}} in the dispatch
    format; ``params`` is the weight tree to serve with — the reference's
    stacked layout when loaded from a bundle, the port's layout when built
    by :func:`build_artifact` (``ServeEngine`` accepts either)."""
    policy: SitePolicy
    masks: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    act_absmax: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    smooth_factors: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    scan_qparams: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kernel_buffers: Dict[str, Dict[str, np.ndarray]] = dataclasses.field(
        default_factory=dict)
    params: Any = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kv_calib: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path) -> "QuantArtifact":
        groups, meta = ckpt.load_bundle(path, _GROUPS)
        policy = SitePolicy.from_json(meta.pop("policy"))
        version = meta.pop("format_version", None)
        if not isinstance(version, int) or not 1 <= version <= _FORMAT_VERSION:
            raise ValueError(f"unsupported artifact format {version!r}")
        prequantized = meta.pop("prequantized", bool(groups["params"]))
        params = ckpt.nest(groups["params"]) if prequantized else None
        return cls(policy=policy, masks=groups["masks"],
                   act_absmax=groups["act_absmax"],
                   smooth_factors=groups["smooth_factors"],
                   scan_qparams=_unflatten_nested(groups["scan_qparams"]),
                   kernel_buffers=_unflatten_nested(groups["kernel_buffers"]),
                   params=params, meta=meta, kv_calib=groups["kv_calib"])


def _fused_sites(cfg, policy: SitePolicy):
    """(eager site, resolved cfg, weight path) for every dense site whose
    policy resolves to the fused backend."""
    for i in range(cfg.n_layers):
        for base, path in SITE_WEIGHT_PATH.items():
            site = f"layer{i}/{base}"
            scfg = policy.resolve(site)
            if scfg.method != "fp" and dispatch.site_backend(scfg) == "fused":
                yield site, scfg, i, path


def pack_kernel_buffers(cfg, params, policy, masks: Dict[str, np.ndarray]
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """Kernel-ready packed buffer per fused-backend site (dispatch format),
    from the port's params (``params["layers"][i]["attn"]["wqkv"]`` ...).
    muxq-family sites need a calibrated static mask: packing bakes the
    channel permutation offline.  Smooth-method sites are not packed here
    (their factors come with torch calibration, a later slice)."""
    policy = as_policy(policy)
    buffers: Dict[str, Dict[str, np.ndarray]] = {}
    for site, scfg, i, (mod, leaf) in _fused_sites(cfg, policy):
        if scfg.method in _SMOOTH_METHODS:
            raise NotImplementedError(
                f"site {site!r}: packing {scfg.method!r} needs smoothing "
                "factors, which the port does not calibrate yet")
        mask = masks.get(site)
        if scfg.method == "muxq" and mask is None:
            raise ValueError(
                f"site {site!r}: fused 'muxq' needs a calibrated static "
                "outlier mask (the channel permutation is baked at pack time)")
        w = params["layers"][i][mod][leaf]
        buffers[site] = dispatch.pack_site_buffer(w, mask, scfg)
    return buffers


def calibrate_model(cfg, params, batches: Iterable, device="cuda"
                    ) -> Tuple[CalibrationStats, Optional[Dict[str, np.ndarray]]]:
    """Eager calibration pass over ``batches`` ({"tokens": [b, s]} each):
    returns (matmul-site ``CalibrationStats``, ``kv_calib`` section or
    None).  The same forwards feed both: the ``CollectCtx`` sees every
    matmul input, the KV observer every layer's post-RoPE K/V."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.serve import kvq

    def forward(p, batch, ctx):
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=device)
        return T.forward(cfg, p, tokens, ctx)

    collector = kvq.KVCalibCollector()
    A.set_kv_observer(collector)
    try:
        stats, _, _ = calibrate(forward, params, batches)
    finally:
        A.set_kv_observer(None)
    return stats, kvq.build_kv_calib(collector)


def build_artifact(cfg, params, policy, masks: Dict[str, np.ndarray], *,
                   kv_calib: Optional[Dict[str, np.ndarray]] = None
                   ) -> QuantArtifact:
    """A servable artifact from the port's params: the policy, the masks
    of its quantized sites, their packed kernel buffers and, for int4 KV
    pages, the ``kv_calib`` section from :func:`calibrate_model`."""
    policy = as_policy(policy)
    buffers = pack_kernel_buffers(cfg, params, policy, masks)
    kept = {s: np.asarray(m) for s, m in masks.items()
            if policy.resolve(s).method != "fp"}
    return QuantArtifact(policy=policy, masks=kept, kernel_buffers=buffers,
                         params=params,
                         meta={"n_sites": len(kept),
                               "n_fused_sites": len(buffers)},
                         kv_calib=dict(kv_calib or {}))
