"""The plain reference that decides ``correct``: the configuration's
mathematics in plain PyTorch, layer by layer, with no kernel, cache,
page or batching of the program's.

It imports nothing of the program.  From the seed it makes the same
weights (``weights.py``) and the same calibration batches the program
got, and works out again everything the program's set-up derived from
them: the calibrated outlier masks of every matmul site (a channel whose
abs-max over the calibration batches exceeds 6, at most a quarter of the
channels), the pooled int4 KV outlier channels (amax over 4x the head's
median, unioned over layers), and the per-column int8 weight codes.  It
then runs each served request's prompt and served tokens through the
model in one pass and returns its logits at every served position:

  * a matmul site is MUXQ as the configuration states it: outlier
    channels shifted down by 2^-2, per-token int8 codes, the integer
    product (exact, in float64) scaled back up by 2^2 on those channels,
    times the token's and the column's scales;
  * K and V go through the page mode's quantizer (int8 a (position,
    head), or int4 with the redistribution and bf16 scales) before
    attention, as a cache that holds them would;
  * activations, norms, attention and the LM head are float32 with TF32
    off (the reference's own precision; the configuration does not
    exclude TF32 for the program, see ``perfbench/configs``).

The calibration pass repeats the program's dense calibration forward op
for op, so both sides pick the same channels from the same numbers.  A
control runs the same pass one step down in precision: int4 weights
(``weight_bits=4``), attention and the LM head in bfloat16
(``float_dtype=torch.bfloat16``), or TF32 matmuls (``tf32=True``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pbench import weights as W

NEG_INF = -1e9
THRESHOLD = 6.0          # |x| that makes a calibration channel an outlier
MAX_FRAC = 0.25          # at most this share of a site's channels
EXP = 2                  # MUXQ's 2^e shift
KV_RATIO = 4.0           # int4 KV: amax over ratio x the head's median


# -- the configuration's elementwise mathematics ---------------------------

def norm(m: Dict, p: Dict, x: torch.Tensor) -> torch.Tensor:
    eps = m["norm_eps"]
    x = x.float()
    if m["norm"] == "rmsnorm":
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + eps)) * (1.0 + p["gain"].float())
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["gain"] + p["bias"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., seq, heads, dh]; positions [..., seq]."""
    dh = x.shape[-1]
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (exps / dh))
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def activation(m: Dict, h: torch.Tensor) -> torch.Tensor:
    if m["mlp_type"] == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        return F.silu(gate.float()) * up
    return F.gelu(h.float(), approximate="tanh")


def heads(m: Dict):
    h, kv = m["n_heads"], m["n_kv_heads"]
    return h, kv, m["d_model"] // h


def split_qkv(m: Dict, qkv: torch.Tensor):
    h, kv, dh = heads(m)
    lead = qkv.shape[:-1]
    return (qkv[..., : h * dh].reshape(*lead, h, dh),
            qkv[..., h * dh: (h + kv) * dh].reshape(*lead, kv, dh),
            qkv[..., (h + kv) * dh:].reshape(*lead, kv, dh))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_block: int = 512, dtype=torch.float32) -> torch.Tensor:
    """Causal grouped-query softmax(QK^T/sqrt(dh)) V of one sequence:
    q [S, h, dh], k/v [S, kvh, dh] -> [S, h, dh], in blocks of query
    rows, summed in ``dtype``."""
    out_dtype = q.dtype
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    s, h, dh = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qg = q.reshape(s, kvh, g, dh)
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        scores = torch.einsum("qkgd,skd->kgqs", qg[lo:hi], k) * dh ** -0.5
        allow = kpos[None, :] <= torch.arange(lo, hi, device=q.device)[:, None]
        scores = scores + torch.where(allow, 0.0, NEG_INF).to(dtype)
        probs = torch.softmax(scores, dim=-1)
        out[lo:hi] = torch.einsum("kgqs,skd->qkgd", probs, v).reshape(hi - lo, h, dh)
    return out.to(out_dtype)


# -- quantizers --------------------------------------------------------------

def _div(x: torch.Tensor, q: float) -> torch.Tensor:
    # an IEEE quotient by a device tensor, as the configuration's
    # quantizers compute it (CUDA divides by a host scalar as a
    # reciprocal multiply)
    return x / torch.full((), q, device=x.device)


def weight_codes(w: torch.Tensor, bits: int):
    """Per-column abs-max codes and scales of W [K, N]."""
    qmax = (1 << (bits - 1)) - 1
    scale = _div(torch.clamp_min(w.abs().amax(dim=0, keepdim=True), 1e-9), qmax)
    codes = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return codes, scale


def muxq_site(x: torch.Tensor, mask: torch.Tensor, codes: torch.Tensor,
              sw: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """x [T, K] f32 through one MUXQ site: outlier channels x 2^-e, per-row
    int8 codes, the integer product with the 2^e multiplier on those
    channels, then the row's and the column's scales."""
    shift = torch.where(mask, 2.0 ** -EXP, 1.0).to(x.dtype)
    mult = torch.where(mask, 2.0 ** EXP, 1.0).double()
    wd = codes.double()
    out = torch.empty((x.shape[0], codes.shape[1]), dtype=torch.float32,
                      device=x.device)
    for lo in range(0, x.shape[0], rows):
        body = x[lo:lo + rows] * shift
        sx = _div(torch.clamp_min(body.abs().amax(dim=-1, keepdim=True), 1e-9), 127)
        xi = torch.clamp(torch.round(body / sx), -127, 127)
        acc = (xi.double() * mult) @ wd
        out[lo:lo + rows] = acc.float() * sx * sw
    return out


def kv_int8(x: torch.Tensor) -> torch.Tensor:
    """[..., kvh, dh] -> the values an int8 page holds, dequantized."""
    s = _div(torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-6), 127)
    return torch.clamp(torch.round(x / s), -127, 127) * s


def kv_int4(x: torch.Tensor, redist: torch.Tensor) -> torch.Tensor:
    """[..., kvh, dh] -> the values an int4 page holds, dequantized:
    outlier channels divided by 2^e, 4-bit codes with a bf16 scale, the
    shift undone on read."""
    body = x / redist
    amax = torch.clamp_min(body.abs().amax(dim=-1, keepdim=True), 1e-6)
    s = _div(amax, 7).to(torch.bfloat16).float()
    return (torch.clamp(torch.round(body / s), -7, 7) * s) * redist


# -- calibration ------------------------------------------------------------

def _site_mask(absmax: np.ndarray) -> np.ndarray:
    m = absmax > THRESHOLD
    cap = max(1, int(MAX_FRAC * len(absmax)))
    if m.sum() > cap:
        m = np.zeros_like(m)
        m[np.argsort(-absmax)[:cap]] = True
    return m


def _pooled_kv_mask(amax: np.ndarray) -> np.ndarray:
    """[L, kvh, dh] -> [kvh, dh]: per layer and head, a channel over
    KV_RATIO x the head's median; unioned over layers; a head with more
    than a quarter of its channels keeps its top ones by pooled amax."""
    amax = np.asarray(amax, np.float32)
    _, kvh, dh = amax.shape
    med = np.maximum(np.median(amax, axis=-1, keepdims=True), 1e-6)
    mask = (amax > KV_RATIO * med).any(axis=0)
    cap = max(1, int(MAX_FRAC * dh))
    pooled = amax.max(axis=0)
    for h in range(kvh):
        if int(mask[h].sum()) > cap:
            keep = np.argsort(pooled[h])[-cap:]
            mask[h] = False
            mask[h, keep] = True
    return mask


class Reference:
    """The reference model of one configuration, seed and page mode."""

    def __init__(self, m: Dict, seed: int, kv_mode: str, device):
        self.m, self.seed, self.kv_mode = m, seed, kv_mode
        self.device = torch.device(device)
        self.masks: Dict[str, np.ndarray] = {}
        self.kv_redist: Optional[Dict[str, torch.Tensor]] = None

    def _layer(self, i: int) -> Dict:
        return W.layer(self.m, self.seed, i, self.device)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return W.embed(self.m, self.seed, self.device)[tokens.long()]

    def calibrate(self, batches: Sequence[np.ndarray]) -> None:
        """The program's dense calibration forward, op for op, on each
        [b, s] batch: the abs-max of every site's input and the post-RoPE
        K/V amax of every layer."""
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            self._calibrate(batches)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    def _calibrate(self, batches: Sequence[np.ndarray]) -> None:
        m = self.m
        h, kv, dh = heads(m)
        xs = [self._embed(torch.as_tensor(b, device=self.device))
              for b in batches]
        absmax: Dict[str, np.ndarray] = {}
        k_amax, v_amax = [], []

        def stat(name, t):
            a = np.abs(t.detach().float().cpu().numpy()).reshape(
                -1, t.shape[-1]).max(axis=0)
            absmax[name] = a if name not in absmax else np.maximum(absmax[name], a)

        for i in range(m["n_layers"]):
            lp = self._layer(i)
            ka = va = None
            for j, x in enumerate(xs):
                b, s, _ = x.shape
                pos = torch.arange(s, device=self.device)[None].expand(b, s)
                hx = norm(m, lp["ln1"], x)
                stat(f"layer{i}/attn_qkv", hx)
                qkv = hx @ lp["attn"]["wqkv"]
                if "bqkv" in lp["attn"]:
                    qkv = qkv + lp["attn"]["bqkv"]
                q, k, v = split_qkv(m, qkv)
                q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
                a_k = np.max(np.abs(k.float().cpu().numpy()), axis=(0, 1))
                a_v = np.max(np.abs(v.float().cpu().numpy()), axis=(0, 1))
                ka = a_k if ka is None else np.maximum(ka, a_k)
                va = a_v if va is None else np.maximum(va, a_v)
                qg = q.reshape(b, s, kv, h // kv, dh)
                scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * dh ** -0.5
                qp = torch.arange(s, device=self.device)[:, None]
                kp = torch.arange(s, device=self.device)[None, :]
                bias = torch.where(kp <= qp, 0.0, NEG_INF).float()[None, None]
                scores = scores + bias[:, :, None]
                probs = torch.softmax(scores, dim=-1)
                o = torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b, s, h * dh)
                stat(f"layer{i}/attn_out", o)
                x = x + o @ lp["attn"]["wo"]
                hx = norm(m, lp["ln2"], x)
                stat(f"layer{i}/mlp_up", hx)
                u = hx @ lp["mlp"]["wi"]
                if "bi" in lp["mlp"]:
                    u = u + lp["mlp"]["bi"]
                u = activation(m, u)
                stat(f"layer{i}/mlp_down", u)
                y = u @ lp["mlp"]["wo"]
                if "bo" in lp["mlp"]:
                    y = y + lp["mlp"]["bo"]
                xs[j] = x + y
            k_amax.append(ka)
            v_amax.append(va)
            del lp
        self.masks = {name: _site_mask(a) for name, a in absmax.items()}
        if self.kv_mode == "int4":
            self.kv_redist = {
                n: torch.where(torch.as_tensor(_pooled_kv_mask(np.stack(a)),
                                               device=self.device),
                               2.0 ** EXP, 1.0).float()
                for n, a in (("k", k_amax), ("v", v_amax))}

    def _kv(self, k, v):
        if self.kv_mode == "int8":
            return kv_int8(k), kv_int8(v)
        if self.kv_mode == "int4":
            return (kv_int4(k, self.kv_redist["k"]),
                    kv_int4(v, self.kv_redist["v"]))
        raise ValueError(f"unknown kv mode {self.kv_mode!r}")

    def logits(self, seqs: List[np.ndarray], first: List[int],
               weight_bits: int = 8, tf32: bool = False,
               float_dtype=torch.float32) -> List[torch.Tensor]:
        """Logits [len(seq) - first, vocab] of each token sequence at
        positions first .. len(seq) - 1 (calibrate first)."""
        m = self.m
        lens = [len(s) for s in seqs]
        offs = np.concatenate([[0], np.cumsum(lens)])
        tokens = torch.as_tensor(np.concatenate(seqs), device=self.device)
        positions = torch.cat([torch.arange(n, device=self.device)
                               for n in lens])
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            x = self._embed(tokens)
            for i in range(m["n_layers"]):
                x = self._block(i, x, positions, offs, weight_bits,
                                float_dtype)
            rows = torch.cat([torch.arange(offs[j] + f, offs[j + 1],
                                           device=self.device)
                              for j, f in enumerate(first)])
            hx = norm(m, W.final_norm(m, self.device), x[rows])
            del x
            head = (W.embed(m, self.seed, self.device).T if m["tie_embeddings"]
                    else W.lm_head(m, self.seed, self.device))
            out = (hx.to(float_dtype) @ head.to(float_dtype)).float()
            out = out[:, : m["vocab_size"]]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag
        counts = [lens[j] - f for j, f in enumerate(first)]
        return list(torch.split(out, counts))

    def _site(self, name: str, x: torch.Tensor, w: torch.Tensor,
              bits: int) -> torch.Tensor:
        codes, sw = weight_codes(w, bits)
        mask = torch.as_tensor(self.masks[name], device=x.device)
        return muxq_site(x, mask, codes, sw)

    def _block(self, i: int, x, positions, offs, bits: int, float_dtype):
        m = self.m
        lp = self._layer(i)
        p = f"layer{i}/"
        qkv = self._site(p + "attn_qkv", norm(m, lp["ln1"], x),
                         lp["attn"]["wqkv"], bits)
        if "bqkv" in lp["attn"]:
            qkv = qkv + lp["attn"]["bqkv"]
        q, k, v = split_qkv(m, qkv)
        del qkv
        q = rope(q[None], positions[None], m["rope_theta"])[0]
        k = rope(k[None], positions[None], m["rope_theta"])[0]
        k, v = self._kv(k, v)
        o = torch.cat([attend(q[a:b], k[a:b], v[a:b], dtype=float_dtype)
                       for a, b in zip(offs[:-1], offs[1:])])
        del q, k, v
        x = x + self._site(p + "attn_out", o.reshape(o.shape[0], -1),
                           lp["attn"]["wo"], bits)
        del o
        u = self._site(p + "mlp_up", norm(m, lp["ln2"], x), lp["mlp"]["wi"],
                       bits)
        if "bi" in lp["mlp"]:
            u = u + lp["mlp"]["bi"]
        u = activation(m, u)
        y = self._site(p + "mlp_down", u, lp["mlp"]["wo"], bits)
        del u
        if "bo" in lp["mlp"]:
            y = y + lp["mlp"]["bo"]
        return x + y


def widest_gap(ref: List[torch.Tensor], tokens: List[np.ndarray]) -> Dict:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position, and how many tokens differ from
    the reference's argmax."""
    gaps = []
    for lg, t in zip(ref, tokens):
        t = torch.as_tensor(np.asarray(t), device=lg.device).long()
        gaps.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
    g = torch.cat(gaps)
    return {"gap": float(g.max()) if g.numel() else math.inf,
            "mean": float(g.mean()) if g.numel() else math.inf,
            "differ": int((g > 0).sum()), "tokens": int(g.numel())}
