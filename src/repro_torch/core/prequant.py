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


# ctx site base name -> the weight leaf it reads inside one layer's params.
# In MoE layers the shared expert runs through mlp() (eager sites
# layer{i}/mlp_up|down) but its weights live under moe/shared/: the
# fallback, which the reference never prequantizes.
SITE_LEAF = {
    "attn_qkv": ("attn", "wqkv"), "attn_out": ("attn", "wo"),
    "cross_q": ("cross", "wq"), "cross_kv": ("cross", "wkv"),
    "cross_out": ("cross", "wo"),
    "mlp_up": ("mlp", "wi"), "mlp_down": ("mlp", "wo"),
    "moe_up": ("moe", "wi"), "moe_down": ("moe", "wo"),
    "ssm_in_zx": ("ssm", "in_zx"), "ssm_in_bcdt": ("ssm", "in_bcdt"),
    "ssm_out": ("ssm", "out_proj"),
}
_SHARED_EXPERT_LEAF = {"mlp_up": ("moe", "shared", "wi"),
                       "mlp_down": ("moe", "shared", "wo")}

# params root -> the eager site prefix of its layers: a list of per-layer
# dicts, or (the hybrid's shared block) one dict that every ``shared{j}/``
# use runs
_SITE_PREFIX = {"layers": "layer", "enc_layers": "enc", "shared": "shared"}


def site_for_path(pathstr: str) -> Optional[str]:
    """ctx site base name for an eligible weight-leaf path, else None."""
    for site, path in SITE_LEAF.items():
        if pathstr.endswith("/".join(path)):
            return site
    return None


def _leaf_at(tree, path):
    for key in path:
        tree = tree.get(key) if isinstance(tree, dict) else None
    return tree


def site_leaves(params, shared_uses: int = 0):
    """(eager site, path, leaf) of every matmul site's weight leaf in the
    port's params: root by root (``layers``, ``enc_layers``, ``shared``),
    site base by base in ``SITE_LEAF``'s order, layer by layer.  ``path``
    runs from the root of ``params`` (``("layers", 3, "attn", "wqkv")``,
    ``("shared", "attn", "wqkv")``); the leaf is in whatever form the tree
    holds.  A layer without an ``mlp`` yields its shared expert's leaves
    for ``mlp_up|down``.  The hybrid's shared block yields one site a use,
    ``shared{j}/`` for j < ``shared_uses``, all at one path."""
    for root, kind in _SITE_PREFIX.items():
        node = params.get(root)
        if node is None:
            continue
        layers = ([(i, (root, i), lp) for i, lp in enumerate(node)]
                  if isinstance(node, list)
                  else [(j, (root,), node) for j in range(shared_uses)])
        for base, path in SITE_LEAF.items():
            for i, at, lp in layers:
                for p in filter(None, (path, _SHARED_EXPERT_LEAF.get(base))):
                    leaf = _leaf_at(lp, p)
                    if leaf is not None:
                        yield f"{kind}{i}/{base}", at + p, leaf
                        break


def leaf_stacks(params, shared_uses: int = 0) -> Dict[tuple, list]:
    """The walker's triples of each leaf over its stack's layers, under
    ``(root, module, key)``; the MoE shared expert is left out (the
    reference never packs it)."""
    stacks: Dict[tuple, list] = {}
    for site, path, leaf in site_leaves(params, shared_uses):
        if path[-3:] not in _SHARED_EXPERT_LEAF.values():
            stacks.setdefault((path[0],) + path[-2:], []).append(
                (site, path, leaf))
    return stacks


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


def stub_leaf(leaf):
    """The inert stand-in of a weight leaf whose site serves from its
    kernel buffer, in the leaf's form with every dim 1: zeros of its
    dtype, or int8 zeros and f32 ones for ``{"q", "s"}``.  A site
    misrouted to the fake backend then fails on shape, not silently on
    garbage."""
    if isinstance(leaf, dict):
        q, s = leaf["q"], leaf["s"]
        return {"q": torch.zeros((1,) * q.ndim, dtype=torch.int8,
                                 device=q.device),
                "s": torch.ones((1,) * s.ndim, dtype=torch.float32,
                                device=s.device)}
    return torch.zeros((1,) * leaf.ndim, dtype=leaf.dtype, device=leaf.device)


def _pack_leaf(leaf: torch.Tensor, bits: int, gran: str, factor=None) -> dict:
    """``{"q", "s"}`` of one layer's leaf, its smooth divisor ``factor``
    ([in_ch]) folded in first.  A stub (every dim 1) packs to the packed
    stub, unquantized."""
    if all(d == 1 for d in leaf.shape):
        return stub_leaf({"q": leaf, "s": leaf})
    if factor is not None:                  # [.., in, out]: s over the rows
        s = torch.as_tensor(np.array(factor, np.float32), device=leaf.device)
        leaf = (leaf * s[:, None]).to(leaf.dtype)
    s = _weight_scale(leaf, bits, gran)
    q, _ = Q.quantize(leaf, bits, scale=s)
    return {"q": q, "s": s.float()}


def with_leaf(tree, path, value):
    """A copy of ``tree`` with the leaf at ``path`` (dict keys and list
    indices) replaced; the lists and dicts along the path are copied, the
    caller's tree stays as it was."""
    if not path:
        return value
    node = list(tree) if isinstance(tree, list) else dict(tree)
    node[path[0]] = with_leaf(tree[path[0]], path[1:], value)
    return node


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
    stacks = leaf_stacks(params, shared_uses=1)
    out = params
    for key in sorted(stacks):          # the reference's order of leaves
        found = stacks[key]
        pathstr = "/".join(key)
        # the shared block packs once, under its bare site names
        names = [site.split("/", 1)[1] if key[0] == "shared" else site
                 for site, _, _ in found]
        bits, gran, fold = weight_bits, "per_channel", [None] * len(found)
        if policy is not None:
            scfg = _pack_cfg(policy, pathstr, names)
            if scfg.method == "fp":
                continue
            bits, gran = scfg.weight_bits, scfg.weight_granularity
            if scfg.method in SMOOTH_METHODS:
                fold = [(smooth_factors or {}).get(nm) for nm in names]
                if key[0] == "shared" or any(f is None for f in fold):
                    raise ValueError(
                        f"weight leaf {pathstr!r}: method "
                        f"{scfg.method!r} needs per-layer smooth "
                        "factors folded into the packed weight, but "
                        "none cover this leaf (shared/multi-instance "
                        "weights cannot fold a per-instance factor) — "
                        "use prequantize=False for this policy")
        for (_, path, leaf), factor in zip(found, fold):
            out = with_leaf(out, path, _pack_leaf(leaf, bits, gran, factor))
    return out


def prequant_bytes(tree) -> int:
    """Bytes of every tensor in a params tree (either leaf form)."""
    if isinstance(tree, dict):
        return sum(prequant_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(prequant_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
