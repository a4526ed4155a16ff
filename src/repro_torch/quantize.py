"""Model quantization: calibrate -> plan -> prequantize -> pack, and the
``QuantArtifact`` that carries the result.

Counterpart of ``repro/quantize.py``.  :func:`quantize_model` turns (model
config, params, calibration batches or precollected stats, policy) into
one :class:`QuantArtifact`: the policy, the calibrated static outlier
masks, the per-site activation abs-max, the folded smoothing divisors of
smooth-method sites, the offline-packed ``{"q", "s"}`` weight tree, the
kernel-ready buffers of fused-backend sites, the stacked ``[L, ...]``
``scan_qparams`` the reference's scanned layer loop reads, and the int4 KV
pages' ``kv_calib``.  :meth:`QuantArtifact.save` writes the reference's
bundle format v3 (``docs/ARTIFACT_FORMAT.md``; the weight tree stacked as
the reference stores it), and :meth:`QuantArtifact.load` reads v1..v3, so
either package serves a bundle the other wrote.  :func:`calibrate_model`
is the calibration pass (the reference's ``_run_calibration``); the
smaller :func:`build_artifact` packs a fused policy's buffers from
already-calibrated masks.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.convert import as_port_params, from_jax_params, to_reference_layout
from repro_torch.core import smoothquant as SQ
from repro_torch.core.calibrate import calibrate
from repro_torch.core.context import QuantCtx, _is_prequant
from repro_torch.core.muxq import SMOOTH_METHODS, QuantConfig
from repro_torch.core.outliers import CalibrationStats
from repro_torch.core.policy import SitePolicy, as_policy
from repro_torch.core.prequant import prequantize_params
from repro_torch.kernels import dispatch

_FORMAT_VERSION = 3
_GROUPS = ("masks", "act_absmax", "smooth_factors", "scan_qparams",
           "kernel_buffers", "params", "kv_calib")

PACK_TARGETS = ("both", "fused", "tree")

# ctx site base name -> weight-leaf path inside one layer's params.  In MoE
# layers the shared expert runs through mlp() (eager sites
# layer{i}/mlp_up|down) but its weights live under moe/shared/: the
# fallback path.
SITE_WEIGHT_PATH = {
    "attn_qkv": ("attn", "wqkv"), "attn_out": ("attn", "wo"),
    "mlp_up": ("mlp", "wi"), "mlp_down": ("mlp", "wo"),
    "moe_up": ("moe", "wi"), "moe_down": ("moe", "wo"),
}
_SITE_WEIGHT_FALLBACK = {
    "mlp_up": ("moe", "shared", "wi"), "mlp_down": ("moe", "shared", "wo"),
}

_SITE_RE = re.compile(r"^(layer)(\d+)/(.+)$")


def split_site(site: str):
    """'layer3/mlp_up' -> ('layer', 3, 'mlp_up'); bare names -> (None, None, site)."""
    m = _SITE_RE.match(site)
    if m is None:
        return None, None, site
    return m.group(1), int(m.group(2)), m.group(3)


def _site_leaf(layer: dict, base: str):
    """(path, leaf) of the weight an eager site base consumes in one
    layer's params ([in_ch, out]; [E, in_ch, out] at an expert site), or
    None where the layer has no such leaf."""
    for path in (SITE_WEIGHT_PATH.get(base), _SITE_WEIGHT_FALLBACK.get(base)):
        if path is None:
            continue
        node = layer
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is not None:
            return path, node
    return None


def _with_leaf(tree: dict, path, value) -> dict:
    """A copy of ``tree`` with the leaf at ``path`` replaced (the dicts
    along the path copied; the caller's tree stays as it was)."""
    if len(path) == 1:
        return {**tree, path[0]: value}
    return {**tree, path[0]: _with_leaf(tree[path[0]], path[1:], value)}


def _site_weight(params, site: str) -> Optional[torch.Tensor]:
    """The 2-D [in_ch, flattened out] weight an eager site of the port's
    params consumes (an expert site's [E, in_ch, out] with the experts
    folded into the out dim), or None when the site has no raw leaf."""
    kind, idx, base = split_site(site)
    if kind != "layer" or idx >= len(params["layers"]):
        return None
    found = _site_leaf(params["layers"][idx], base)
    if found is None or _is_prequant(found[1]):
        return None
    w = found[1]
    return w.movedim(-2, 0).reshape(w.shape[-2], -1)


def _flatten_nested(group: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """One level of dict nesting -> npz keys '{key}#{field}'; array values
    pass through.  Inverse of :func:`_unflatten_nested`."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in group.items():
        if isinstance(val, dict):
            for field, arr in val.items():
                flat[f"{key}#{field}"] = np.asarray(arr)
        else:
            flat[key] = np.asarray(val)
    return flat


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
    """Policy, calibrated state, packed weights and kernel buffers.

    ``kernel_buffers`` is {eager site: {field: array}} in the dispatch
    format; ``params`` is the weight tree to serve with (None for a
    quantize-at-use artifact) — the reference's stacked layout when loaded
    from a bundle, the port's per-layer layout when built here
    (``ServeEngine`` and :meth:`save` take either)."""
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

    @property
    def prequantized(self) -> bool:
        return self.params is not None

    def ctx(self, device="cuda") -> QuantCtx:
        """A QuantCtx wired to this artifact."""
        return QuantCtx(self, device=device)

    def save(self, path, pack_target: str = "both") -> str:
        """Write the bundle (format v3, atomically).  ``pack_target`` drops
        the per-weight copy a deployment never reads (see
        :func:`apply_pack_target`); ``meta.json`` records the choice."""
        art = apply_pack_target(self, pack_target)
        groups = {
            "masks": art.masks,
            "act_absmax": art.act_absmax,
            "smooth_factors": art.smooth_factors,
            "scan_qparams": _flatten_nested(art.scan_qparams),
            "kernel_buffers": _flatten_nested(art.kernel_buffers),
            "params": (ckpt.flatten(to_reference_layout(art.params))
                       if art.prequantized else {}),
            "kv_calib": art.kv_calib,
        }
        meta = {"format_version": _FORMAT_VERSION,
                "policy": art.policy.to_json(),
                "prequantized": art.prequantized,
                **art.meta}
        return str(ckpt.save_bundle(path, groups, meta))

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


# ---------------------------------------------------------------------------
# Pack targets: drop the per-weight copy the deployment never reads
# ---------------------------------------------------------------------------

def _defused_policy(policy: SitePolicy) -> SitePolicy:
    """Every fused-backend config rewritten to the fake backend (the 'tree'
    target drops the kernel buffers, so fused routing must go too)."""
    def defuse(c: QuantConfig) -> QuantConfig:
        if c.method != "fp" and c.backend == "fused":
            return c.replace(backend="fake")
        return c
    return SitePolicy(default=defuse(policy.default),
                      rules=tuple((p, defuse(c)) for p, c in policy.rules))


def apply_pack_target(artifact: QuantArtifact, pack_target: str) -> QuantArtifact:
    """Drop the duplicate per-weight copy a single-backend deployment never
    reads (a fused site is otherwise stored twice: its ``{"q", "s"}`` tree
    leaf and its packed kernel buffer).

      * ``"both"``  — keep both (the artifact serves either backend);
      * ``"fused"`` — a weight leaf whose every layer is fused keeps only
        the kernel buffers: its tree leaves shrink to inert all-ones-shape
        stubs (stacked: [L, 1, 1]), so misrouting it to the fake backend
        fails on shape, not silently on garbage;
      * ``"tree"``  — drop the kernel buffers and the ``@fused`` scan
        stacks, and rewrite the policy's fused backends to ``fake``.
    """
    if pack_target not in PACK_TARGETS:
        raise ValueError(f"unknown pack_target {pack_target!r} "
                         f"(expected one of {PACK_TARGETS})")
    if pack_target == "both":
        return artifact
    if pack_target == "tree":
        scan_qp = {k: v for k, v in artifact.scan_qparams.items()
                   if not k.endswith("@fused")}
        return dataclasses.replace(
            artifact, policy=_defused_policy(artifact.policy),
            kernel_buffers={}, scan_qparams=scan_qp,
            meta={**artifact.meta, "pack_target": "tree", "n_fused_sites": 0})

    meta = {**artifact.meta, "pack_target": "fused"}
    params = artifact.params
    if params is None or not artifact.kernel_buffers:
        return dataclasses.replace(artifact, meta=meta)
    if isinstance(params["layers"], dict):      # loaded from a bundle
        params = from_jax_params(None, params, "cpu")
    layers = list(params["layers"])
    for base in SITE_WEIGHT_PATH:
        if not all(f"layer{i}/{base}" in artifact.kernel_buffers
                   for i in range(len(layers))):
            continue                    # partial fused coverage: keep the copy
        found = [_site_leaf(lp, base) for lp in layers]
        if not all(f is not None and _is_prequant(f[1]) for f in found):
            continue                    # not packed (fp site, shared expert)
        for i, (path, leaf) in enumerate(found):
            stub = {"q": torch.zeros((1,) * leaf["q"].ndim, dtype=torch.int8,
                                     device=leaf["q"].device),
                    "s": torch.ones((1,) * leaf["s"].ndim, dtype=torch.float32,
                                    device=leaf["s"].device)}
            layers[i] = _with_leaf(layers[i], path, stub)
    return dataclasses.replace(artifact, params={**params, "layers": layers},
                               meta=meta)


# ---------------------------------------------------------------------------
# Calibration, packing and the quantize_model entry point
# ---------------------------------------------------------------------------

def _scan_key(cfg, base: str) -> str:
    """The bare key the reference's scanned layer loop reads for an eager
    site base: in MoE layers the shared expert's sites
    ``layer{i}/mlp_up|down`` read ``moe_shared_up|down``."""
    if cfg.family == "moe" and base in ("mlp_up", "mlp_down"):
        return "moe_shared_" + base.split("_", 1)[1]
    return base


def _stack_qparams(cfg, masks: Dict[str, np.ndarray],
                   factors: Dict[str, np.ndarray],
                   buffers: Optional[Dict[str, dict]] = None) -> Dict[str, Any]:
    """{bare site: [L, ch]} stacked state for the reference's scanned layer
    loop (the port runs its layers eagerly and never reads it; the bundle
    carries it so the reference serves a port-written bundle as its own).
    Masks stack under the bare site (``_scan_key``), factors under
    '{site}@smooth', kernel buffers field-wise under '{site}@fused' (layers
    whose packed widths differ padded first to one K_pad with inert
    blocks).  Sites that miss a layer are left out."""
    out: Dict[str, Any] = {}
    for source, suffix in ((masks, ""), (factors, "@smooth")):
        bases = {split_site(s)[2] for s in source if split_site(s)[0] == "layer"}
        for base in sorted(bases):
            vals = [source.get(f"layer{i}/{base}") for i in range(cfg.n_layers)]
            if any(v is None for v in vals):
                continue
            out[_scan_key(cfg, base) + suffix] = np.stack(
                [np.asarray(v) for v in vals])
    buffers = buffers or {}
    bases = {split_site(s)[2] for s in buffers if split_site(s)[0] == "layer"}
    for base in sorted(bases):
        vals = [buffers.get(f"layer{i}/{base}") for i in range(cfg.n_layers)]
        if any(v is None for v in vals):
            continue
        k_pad = max(dispatch.buffer_k_pad(v) for v in vals)
        vals = [dispatch.pad_buffer_to(v, k_pad) for v in vals]
        out[_scan_key(cfg, base) + "@fused"] = {
            f: np.stack([v[f] for v in vals]) for f in dispatch.BUFFER_FIELDS}
    return out


def _fused_sites(cfg, params, policy: SitePolicy):
    """(eager site, resolved cfg, weight leaf) for every site of the port's
    params whose policy resolves to the fused backend."""
    for i in range(cfg.n_layers):
        for base in SITE_WEIGHT_PATH:
            found = _site_leaf(params["layers"][i], base)
            if found is None:
                continue
            site = f"layer{i}/{base}"
            scfg = policy.resolve(site)
            if scfg.method != "fp" and dispatch.site_backend(scfg) == "fused":
                yield site, scfg, found[1]


def pack_kernel_buffers(cfg, params, policy, masks: Dict[str, np.ndarray],
                        factors: Optional[Dict[str, np.ndarray]] = None
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """Kernel-ready packed buffer per fused-backend site (dispatch format),
    from the port's params (a weight on the card packs there).
    muxq-family sites need a calibrated static mask (packing bakes the
    channel permutation); smooth-method sites fold their divisor into the
    weight first (``Q(s*W)``), as ``prequantize_params`` does, and the
    runtime applies X/s."""
    policy = as_policy(policy)
    buffers: Dict[str, Dict[str, np.ndarray]] = {}
    for site, scfg, w in _fused_sites(cfg, params, policy):
        mask = masks.get(site)
        if scfg.method in ("muxq", "muxq_smooth") and mask is None:
            raise ValueError(
                f"site {site!r}: fused {scfg.method!r} needs a calibrated "
                "static outlier mask (the channel permutation is baked at "
                "pack time)")
        if scfg.method in SMOOTH_METHODS:
            factor = (factors or {}).get(site)
            if factor is None:
                raise ValueError(
                    f"site {site!r}: fused {scfg.method!r} needs folded "
                    "smooth factors — pass calibration data")
            s = torch.as_tensor(np.array(factor, np.float32), device=w.device)
            w = (w * s[:, None]).to(w.dtype)       # [.., in, out]: s over rows
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


def quantize_model(cfg, params, calib: Union[None, CalibrationStats, Iterable],
                   policy: Union[QuantConfig, SitePolicy], *,
                   prequantize: bool = True, pack_target: str = "both",
                   device="cuda") -> QuantArtifact:
    """calibrate -> plan -> prequantize -> pack, in one call.

    ``params``: the port's (or the reference's stacked) tree; it runs on
    ``device``.  ``calib``: batches ({"tokens": [b, s]}) that
    :func:`calibrate_model` runs through the dense ``forward`` (matmul
    stats and the int4 KV pages' ``kv_calib``), a precollected
    :class:`CalibrationStats` (no forwards, no ``kv_calib``), or None when
    the policy needs no calibration.  ``prequantize=False`` skips weight
    packing (the paper's fake-quant evaluation protocol).  ``pack_target``:
    see :func:`apply_pack_target`."""
    policy = as_policy(policy)
    params = as_port_params(cfg, params, device)
    stats: Optional[CalibrationStats] = None
    kv_calib = None
    if isinstance(calib, CalibrationStats):
        stats = calib
    elif calib is not None:
        stats, kv_calib = calibrate_model(cfg, params, calib, device)
    if stats is None and policy.needs_calibration():
        raise ValueError("policy needs static masks / smoothing factors but "
                         "no calibration data or stats were given")

    masks: Dict[str, np.ndarray] = {}
    absmax: Dict[str, np.ndarray] = {}
    factors: Dict[str, np.ndarray] = {}
    for site, st in (stats.sites.items() if stats else ()):
        scfg = policy.resolve(site)
        if scfg.method == "fp":
            continue
        absmax[site] = np.asarray(st.absmax, np.float32)
        if scfg.outlier_mode == "static":
            masks[site] = np.asarray(st.mask(scfg.outlier_threshold))
        if scfg.method in SMOOTH_METHODS:
            w2 = _site_weight(params, site)
            if w2 is None:
                if prequantize:
                    raise ValueError(
                        f"cannot fold smoothing for site {site!r}: no "
                        "addressable weight leaf (use prequantize=False)")
                continue
            factors[site] = SQ.smoothing_factors(
                torch.from_numpy(absmax[site]), w2,
                scfg.smooth_alpha).cpu().numpy()

    packed = None
    buffers: Dict[str, Dict[str, np.ndarray]] = {}
    if prequantize:
        packed = prequantize_params(cfg, params, policy=policy,
                                    smooth_factors=factors)
        buffers = pack_kernel_buffers(cfg, params, policy, masks, factors)
    art = QuantArtifact(
        policy=policy, masks=masks, act_absmax=absmax, smooth_factors=factors,
        scan_qparams=_stack_qparams(cfg, masks, factors, buffers),
        kernel_buffers=buffers, params=packed,
        meta={"n_sites": len(absmax), "n_fused_sites": len(buffers)},
        kv_calib=kv_calib or {})
    return apply_pack_target(art, pack_target)


def save_artifact(artifact: QuantArtifact, path) -> str:
    return artifact.save(path)


def load_artifact(path) -> QuantArtifact:
    return QuantArtifact.load(path)


def build_artifact(cfg, params, policy, masks: Dict[str, np.ndarray], *,
                   kv_calib: Optional[Dict[str, np.ndarray]] = None
                   ) -> QuantArtifact:
    """A servable artifact from the port's params and calibrated masks: the
    policy, the masks of its quantized sites, their packed kernel buffers
    and, for int4 KV pages, ``kv_calib``.  The raw params ride along as the
    weights to serve with (fused sites never read them)."""
    policy = as_policy(policy)
    buffers = pack_kernel_buffers(cfg, params, policy, masks)
    kept = {s: np.asarray(m) for s, m in masks.items()
            if policy.resolve(s).method != "fp"}
    return QuantArtifact(policy=policy, masks=kept, kernel_buffers=buffers,
                         params=params,
                         meta={"n_sites": len(kept),
                               "n_fused_sites": len(buffers)},
                         kv_calib=dict(kv_calib or {}))
