"""Offline weight pre-quantization (the deployment path), counterpart of
``repro/core/prequant.py`` on the port's per-layer layout.

Every quantized-site weight leaf becomes ``{"q": int8, "s": f32 scales}``:
the serving step reads one byte a weight and never re-quantizes.  Packing
follows the policy: each site packs at its resolved weight bits and
granularity (fp sites keep their leaf), and smooth-method sites fold
their per-channel divisor into the weight first (``Q(s*W)``), so the
runtime applies only X/s.  Embeddings, norms and biases stay as they are.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import quantizers as Q
from repro_torch.core.muxq import SMOOTH_METHODS
from repro_torch.core.policy import SitePolicy


# weight-path suffix -> the ctx site base name it is consumed under (the
# dense family's matmul right-hand sides, the leaves eligible for int8)
_SITE_BY_SUFFIX = {
    "attn/wqkv": "attn_qkv", "attn/wo": "attn_out",
    "mlp/wi": "mlp_up", "mlp/wo": "mlp_down",
}


def site_for_path(pathstr: str) -> Optional[str]:
    """ctx site base name for an eligible weight-leaf path, else None."""
    for suffix, site in _SITE_BY_SUFFIX.items():
        if pathstr.endswith(suffix):
            return site
    return None


def _pack_cfg(policy: SitePolicy, pathstr: str, site: str, n_layers: int):
    """The pack-relevant config of one weight leaf of the layer stack.

    The saved bundle stacks each leaf over the layers (the reference's
    layout), so the projection that decides its packing — fp-ness,
    smooth-ness, weight bits, weight granularity — must agree across every
    layer's eager site; a layer-targeted rule that splits it raises."""
    cfgs = [policy.resolve(f"layer{i}/{site}") for i in range(n_layers)]
    keys = {(c.method == "fp", c.method in SMOOTH_METHODS,
             c.weight_bits, c.weight_granularity) for c in cfgs}
    if len(keys) > 1:
        raise ValueError(
            f"weight leaf {pathstr!r}: policy resolves layer-heterogeneous "
            f"pack configs {sorted(keys)}; stacked weight leaves pack "
            "uniformly — make layer-targeted rules agree on fp/smooth/"
            "weight_bits/weight_granularity, or use prequantize=False")
    return cfgs[0]


def _weight_scale(leaf: torch.Tensor, bits: int, granularity: str) -> torch.Tensor:
    """Scale with keepdims, reducing the contraction axis (-2), plus the out
    axis (-1) for per_tensor.  Divides by a device tensor (see
    ``quantizers.absmax_scale``): the IEEE quotient the reference takes."""
    dims = {"per_channel": (-2,), "per_tensor": (-2, -1),
            "per_token": (-1,)}[granularity]
    amax = torch.clamp_min(torch.abs(leaf.float()).amax(dim=dims, keepdim=True),
                           1e-9)
    return amax / torch.full((), float(Q.qmax(bits)), device=amax.device)


def _pack_leaf(leaf: torch.Tensor, bits: int, gran: str) -> dict:
    s = _weight_scale(leaf, bits, gran)
    q, _ = Q.quantize(leaf, bits, scale=s)
    return {"q": q, "s": s.float()}


def prequantize_params(cfg, params, weight_bits: int = 8, *,
                       policy: Optional[SitePolicy] = None,
                       smooth_factors: Optional[Dict[str, np.ndarray]] = None):
    """The port's params with eligible weight leaves replaced by
    ``{"q": int8 [in, out], "s": f32 [1, out]}`` (per_channel; [1, 1] per
    tensor).  With ``policy``, each site packs at its resolved weight bits
    and granularity (fp sites pass through untouched), and
    ``smooth_factors`` ({eager site: [in_ch] divisor}) fold into
    smooth-method sites before quantizing."""
    layers = params["layers"]
    n = len(layers)
    new_layers = [dict(lp) for lp in layers]
    for mod in sorted({m for lp in layers for m in lp}):
        sub = layers[0].get(mod)
        if not isinstance(sub, dict):
            continue
        for key in sub:
            pathstr = f"layers/{mod}/{key}"
            site = site_for_path(pathstr)
            if site is None:
                continue
            bits, gran, fold = weight_bits, "per_channel", None
            if policy is not None:
                scfg = _pack_cfg(policy, pathstr, site, n)
                if scfg.method == "fp":
                    continue
                bits, gran = scfg.weight_bits, scfg.weight_granularity
                if scfg.method in SMOOTH_METHODS:
                    fold = [(smooth_factors or {}).get(f"layer{i}/{site}")
                            for i in range(n)]
                    if any(f is None for f in fold):
                        raise ValueError(
                            f"weight leaf {pathstr!r}: method {scfg.method!r} "
                            "needs per-layer smooth factors folded into the "
                            "packed weight, but none cover this leaf — use "
                            "prequantize=False for this policy")
            for i, lp in enumerate(new_layers):
                leaf = layers[i][mod][key]
                if fold is not None:
                    s = torch.as_tensor(np.array(fold[i], np.float32),
                                        device=leaf.device)
                    leaf = (leaf * s[:, None]).to(leaf.dtype)
                lp[mod] = {**lp[mod], key: _pack_leaf(leaf, bits, gran)}
    return {**params, "layers": new_layers}


def prequant_bytes(tree) -> int:
    """Bytes of every tensor in a params tree (either leaf form)."""
    if isinstance(tree, dict):
        return sum(prequant_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(prequant_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
