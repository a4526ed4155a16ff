"""Seeded weights of a dense decoder, made on the device in one large
random call a layer, in the port's tree layout.

The benchmark makes the weights itself and hands the same tensors to the
program and, made again layer by layer from the same seed, to the plain
reference.  Layer ``i`` draws from its own generator, seeded from
(seed, i), so the reference can make one layer at a time.

Random weights carry no outliers, and MUXQ exists for models whose
activations have them, so the weights plant them: 8 norm gain channels
scaled x20 (activation outliers at every site that reads a norm's output)
and two K channels of the QKV projection scaled x20 (KV outliers for the
int4 pages' redistribution).  The same channels in every layer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_MASK = (1 << 63) - 1
HOT_CHANNELS = 8
HOT_SCALE = 20.0


def derive(seed: int, tag: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream tag."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (tag + 1)) & _MASK


def _gen(device, seed: int, tag: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def site_shapes(m: Dict) -> List[Tuple[str, str, Tuple[int, int]]]:
    """(module, leaf, [in, out]) of a layer's four matmul sites, in the
    order they are drawn."""
    d, h, kv, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    dh = d // h
    up = 2 * f if m["mlp_type"] == "swiglu" else f
    return [("attn", "wqkv", (d, (h + 2 * kv) * dh)),
            ("attn", "wo", (h * dh, d)),
            ("mlp", "wi", (d, up)),
            ("mlp", "wo", (f, d))]


def hot_channels(m: Dict, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(derive(seed, 1 << 20))
    return torch.randperm(m["d_model"], generator=g)[:HOT_CHANNELS]


def k_hot_columns(m: Dict) -> List[int]:
    """Two K columns of wqkv: one in the first KV head, one in the last."""
    d, h, kv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    dh = d // h
    k0 = h * dh
    return [k0 + 5, k0 + dh * (kv - 1) + (dh // 2 + 5) % dh]


def _norm(m: Dict, hot: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    d = m["d_model"]
    if m["norm"] == "rmsnorm":          # the port's RMSNorm scales by (1 + gain)
        gain = torch.zeros(d, device=device)
        gain[hot.to(device)] = HOT_SCALE - 1.0
        return {"gain": gain}
    gain = torch.ones(d, device=device)
    gain[hot.to(device)] = HOT_SCALE
    return {"gain": gain, "bias": torch.zeros(d, device=device)}


def layer(m: Dict, seed: int, i: int, device) -> Dict:
    """Layer ``i``'s weights: one randn call for the four site weights
    (views of one buffer, each scaled by 1/sqrt(fan_in)), one for the
    biases."""
    g = _gen(device, seed, 2 + i)
    shapes = site_shapes(m)
    sizes = [a * b for _, _, (a, b) in shapes]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out: Dict = {"attn": {}, "mlp": {}}
    at = 0
    for (mod, leaf, (k, n)), size in zip(shapes, sizes):
        w = flat[at:at + size].view(k, n)
        w.mul_(1.0 / math.sqrt(k))
        out[mod][leaf] = w
        at += size
    out["attn"]["wqkv"][:, k_hot_columns(m)] *= HOT_SCALE
    biases = []
    if m["qkv_bias"]:
        biases.append(("attn", "bqkv", shapes[0][2][1]))
    if m["mlp_type"] != "swiglu":
        biases += [("mlp", "bi", m["d_ff"]), ("mlp", "bo", m["d_model"])]
    if biases:
        b = 0.02 * torch.randn(sum(n for _, _, n in biases), generator=g,
                               device=device)
        at = 0
        for mod, leaf, n in biases:
            out[mod][leaf] = b[at:at + n].clone()
            at += n
    hot = hot_channels(m, seed)
    out["ln1"] = _norm(m, hot, device)
    out["ln2"] = _norm(m, hot, device)
    return out


def padded_vocab(m: Dict) -> int:
    return ((m["vocab_size"] + 127) // 128) * 128


def embed(m: Dict, seed: int, device) -> torch.Tensor:
    g = _gen(device, seed, 0)
    return 0.02 * torch.randn((padded_vocab(m), m["d_model"]), generator=g,
                              device=device)


def lm_head(m: Dict, seed: int, device) -> torch.Tensor:
    """The untied head [d, V_pad]."""
    g = _gen(device, seed, 1)
    w = torch.randn((m["d_model"], padded_vocab(m)), generator=g,
                    device=device)
    return w.mul_(1.0 / math.sqrt(m["d_model"]))


def final_norm(m: Dict, device) -> Dict[str, torch.Tensor]:
    d = m["d_model"]
    if m["norm"] == "rmsnorm":
        return {"gain": torch.zeros(d, device=device)}
    return {"gain": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def tree(m: Dict, seed: int, device) -> Dict:
    """The whole model in the port's layout (``embed``, ``ln_f``,
    ``layers``, and ``lm_head`` when untied)."""
    params = {"embed": embed(m, seed, device), "ln_f": final_norm(m, device),
              "layers": [layer(m, seed, i, device)
                         for i in range(m["n_layers"])]}
    if not m["tie_embeddings"]:
        params["lm_head"] = lm_head(m, seed, device)
    return params
