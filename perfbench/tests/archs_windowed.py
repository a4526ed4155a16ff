"""A toy architecture for the harness's tests, in the form of an
``archs/<name>.py`` file (see ``pbench.cells.arch``): the dense pre-norm
decoder of ``pbench.weights`` and ``pbench.reference``, whose layers that
``block_pattern`` marks ``"local"`` attend to the last ``window_size``
positions only, as the program's sliding-window layers do.

The weights are the dense decoder's.  The reference repeats the base
class's calibration forward and block with the window's mask on the
local layers.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pbench import reference as R
from pbench import weights as W

tree = W.tree

WINDOWED = ("local",)    # the layer kinds that see the window


def window(m: Dict, i: int) -> Optional[int]:
    """Layer ``i``'s window, or None where it attends to every position."""
    pat = m["block_pattern"]
    return m["window_size"] if pat[i % len(pat)] in WINDOWED else None


def allowed(sq: int, sk: int, win: Optional[int], device,
            q0: int = 0) -> torch.Tensor:
    """[sq, sk]: key s is visible to query q0 + q."""
    qpos = torch.arange(q0, q0 + sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    allow = kpos <= qpos
    if win is not None:
        allow = allow & (kpos > qpos - win)
    return allow


def attend(q, k, v, win: Optional[int], q_block: int = 512,
           dtype=torch.float32) -> torch.Tensor:
    """``reference.attend`` with keys outside the window masked."""
    out_dtype = q.dtype
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    s, h, dh = q.shape
    kvh = k.shape[1]
    qg = q.reshape(s, kvh, h // kvh, dh)
    out = torch.empty_like(q)
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        scores = torch.einsum("qkgd,skd->kgqs", qg[lo:hi], k) * dh ** -0.5
        allow = allowed(hi - lo, s, win, q.device, lo)
        scores = scores + torch.where(allow, 0.0, R.NEG_INF).to(dtype)
        probs = torch.softmax(scores, dim=-1)
        out[lo:hi] = torch.einsum("kgqs,skd->qkgd", probs, v).reshape(
            hi - lo, h, dh)
    return out.to(out_dtype)


class Reference(R.Reference):
    """``reference.Reference`` with the window on the local layers."""

    def _calibrate(self, batches: Sequence[np.ndarray]) -> None:
        m = self.m
        h, kv, dh = R.heads(m)
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
                hx = R.norm(m, lp["ln1"], x)
                stat(f"layer{i}/attn_qkv", hx)
                qkv = hx @ lp["attn"]["wqkv"]
                if "bqkv" in lp["attn"]:
                    qkv = qkv + lp["attn"]["bqkv"]
                q, k, v = R.split_qkv(m, qkv)
                q, k = R.rope(q, pos, m["rope_theta"]), R.rope(k, pos, m["rope_theta"])
                a_k = np.max(np.abs(k.float().cpu().numpy()), axis=(0, 1))
                a_v = np.max(np.abs(v.float().cpu().numpy()), axis=(0, 1))
                ka = a_k if ka is None else np.maximum(ka, a_k)
                va = a_v if va is None else np.maximum(va, a_v)
                qg = q.reshape(b, s, kv, h // kv, dh)
                scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * dh ** -0.5
                allow = allowed(s, s, window(m, i), self.device)
                bias = torch.where(allow, 0.0, R.NEG_INF).float()[None, None]
                scores = scores + bias[:, :, None]
                probs = torch.softmax(scores, dim=-1)
                o = torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b, s, h * dh)
                stat(f"layer{i}/attn_out", o)
                x = x + o @ lp["attn"]["wo"]
                hx = R.norm(m, lp["ln2"], x)
                stat(f"layer{i}/mlp_up", hx)
                u = hx @ lp["mlp"]["wi"]
                if "bi" in lp["mlp"]:
                    u = u + lp["mlp"]["bi"]
                u = R.activation(m, u)
                stat(f"layer{i}/mlp_down", u)
                y = u @ lp["mlp"]["wo"]
                if "bo" in lp["mlp"]:
                    y = y + lp["mlp"]["bo"]
                xs[j] = x + y
            k_amax.append(ka)
            v_amax.append(va)
            del lp
        self.masks = {name: R._site_mask(a) for name, a in absmax.items()}
        if self.kv_mode == "int4":
            self.kv_redist = {
                n: torch.where(torch.as_tensor(R._pooled_kv_mask(np.stack(a)),
                                               device=self.device),
                               2.0 ** R.EXP, 1.0).float()
                for n, a in (("k", k_amax), ("v", v_amax))}

    def _block(self, i: int, x, positions, offs, bits: int, float_dtype):
        m = self.m
        lp = self._layer(i)
        p = f"layer{i}/"
        qkv = self._site(p + "attn_qkv", R.norm(m, lp["ln1"], x),
                         lp["attn"]["wqkv"], bits)
        if "bqkv" in lp["attn"]:
            qkv = qkv + lp["attn"]["bqkv"]
        q, k, v = R.split_qkv(m, qkv)
        del qkv
        q = R.rope(q[None], positions[None], m["rope_theta"])[0]
        k = R.rope(k[None], positions[None], m["rope_theta"])[0]
        k, v = self._kv(k, v)
        win = window(m, i)
        o = torch.cat([attend(q[a:b], k[a:b], v[a:b], win, dtype=float_dtype)
                       for a, b in zip(offs[:-1], offs[1:])])
        del q, k, v
        x = x + self._site(p + "attn_out", o.reshape(o.shape[0], -1),
                           lp["attn"]["wo"], bits)
        del o
        u = self._site(p + "mlp_up", R.norm(m, lp["ln2"], x), lp["mlp"]["wi"],
                       bits)
        if "bi" in lp["mlp"]:
            u = u + lp["mlp"]["bi"]
        u = R.activation(m, u)
        y = self._site(p + "mlp_down", u, lp["mlp"]["wo"], bits)
        del u
        if "bo" in lp["mlp"]:
            y = y + lp["mlp"]["bo"]
        return x + y
