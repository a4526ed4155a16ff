"""Offline weight pre-quantization (the deployment path), counterpart of
``repro/core/prequant.py`` on the port's per-layer layout.

Every quantized-site weight leaf becomes ``{"q": int8, "s": f32 scales}``:
the serving step reads one byte a weight and never re-quantizes.  Packing
follows the policy: each site packs at its resolved weight bits and
granularity (fp sites keep their leaf), and smooth-method sites fold
their per-channel divisor into the weight first (``Q(s*W)``), so the
runtime applies only X/s.  The eligible leaves are the matmul right-hand
sides of every family: attention (``attn/wqkv|wo``), whisper's cross
attention (``cross/wq|wkv|wo``), the MLP, the MoE experts (``moe/wi|wo``,
[E, in, out], packed per expert and out channel) and the Mamba2
projections (``ssm/in_zx|in_bcdt|out_proj``), in the decoder stack
(``layers``, sites ``layer{i}/``), the encoder stack (``enc_layers``,
``enc{i}/``) and the hybrid's one shared block (``shared``).  Embeddings,
norms, biases, the router, the conv and SSD parameters and the shared
expert (its leaves sit under ``moe/shared/``, as in the reference, which
leaves them unpacked) stay as they are.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import quantizers as Q
from repro_torch.core.muxq import SMOOTH_METHODS
from repro_torch.core.policy import SitePolicy


# weight-path suffix -> the ctx site base name it is consumed under
_SITE_BY_SUFFIX = {
    "attn/wqkv": "attn_qkv", "attn/wo": "attn_out",
    "cross/wq": "cross_q", "cross/wkv": "cross_kv", "cross/wo": "cross_out",
    "mlp/wi": "mlp_up", "mlp/wo": "mlp_down",
    "moe/wi": "moe_up", "moe/wo": "moe_down",
    "ssm/in_zx": "ssm_in_zx", "ssm/in_bcdt": "ssm_in_bcdt",
    "ssm/out_proj": "ssm_out",
}

# params root -> the eager site prefix of its i-th layer, in the
# reference's order of leaves (sorted keys).  The hybrid's shared block is
# one weight run at several places: no per-instance prefix, and no
# per-instance smoothing factor can fold into it.
_ROOTS = (("enc_layers", "enc{}/"), ("layers", "layer{}/"), ("shared", None))


def site_for_path(pathstr: str) -> Optional[str]:
    """ctx site base name for an eligible weight-leaf path, else None."""
    for suffix, site in _SITE_BY_SUFFIX.items():
        if pathstr.endswith(suffix):
            return site
    return None


def _pack_cfg(policy: SitePolicy, pathstr: str, names):
    """The pack-relevant config of one weight leaf, used at the eager
    sites ``names`` (one a layer of a stack).

    The saved bundle stacks each leaf over the layers (the reference's
    layout), so the projection that decides its packing — fp-ness,
    smooth-ness, weight bits, weight granularity — must agree across every
    layer's eager site; a layer-targeted rule that splits it raises."""
    cfgs = [policy.resolve(nm) for nm in names]
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
    axis (-1) for per_tensor, so a per-expert leaf [E, in, out] scales per
    expert.  Divides by a device tensor (see
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
    tensor; a per-expert leaf [E, in, out] gets scales [E, 1, out]).
    With ``policy``, each site packs at its resolved weight bits and
    granularity (fp sites pass through untouched), and ``smooth_factors``
    ({eager site: [in_ch] divisor}) fold into smooth-method sites before
    quantizing; the shared block of the hybrid cannot take them and
    raises."""
    out = dict(params)
    for root, fmt in _ROOTS:
        if root not in params:
            continue
        stacked = isinstance(params[root], list)
        layers = params[root] if stacked else [params[root]]
        new_layers = [dict(lp) for lp in layers]
        for mod in sorted({m for lp in layers for m in lp}):
            sub = layers[0].get(mod)
            if not isinstance(sub, dict):
                continue
            for key in sorted(sub):
                pathstr = f"{root}/{mod}/{key}"
                site = site_for_path(pathstr)
                if site is None:
                    continue
                names = ([fmt.format(i) + site for i in range(len(layers))]
                         if fmt else [site])
                bits, gran, fold = weight_bits, "per_channel", None
                if policy is not None:
                    scfg = _pack_cfg(policy, pathstr, names)
                    if scfg.method == "fp":
                        continue
                    bits, gran = scfg.weight_bits, scfg.weight_granularity
                    if scfg.method in SMOOTH_METHODS:
                        fold = [(smooth_factors or {}).get(nm) for nm in names]
                        if fmt is None or any(f is None for f in fold):
                            raise ValueError(
                                f"weight leaf {pathstr!r}: method "
                                f"{scfg.method!r} needs per-layer smooth "
                                "factors folded into the packed weight, but "
                                "none cover this leaf (shared/multi-instance "
                                "weights cannot fold a per-instance factor) — "
                                "use prequantize=False for this policy")
                for i, lp in enumerate(new_layers):
                    leaf = layers[i][mod][key]
                    if fold is not None:     # [.., in, out]: s over the rows
                        s = torch.as_tensor(np.array(fold[i], np.float32),
                                            device=leaf.device)
                        leaf = (leaf * s[:, None]).to(leaf.dtype)
                    lp[mod] = {**lp[mod], key: _pack_leaf(leaf, bits, gran)}
        out[root] = new_layers if stacked else new_layers[0]
    return out


def prequant_bytes(tree) -> int:
    """Bytes of every tensor in a params tree (either leaf form)."""
    if isinstance(tree, dict):
        return sum(prequant_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(prequant_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
