"""Parameter layout conversion between the reference and the port.

The reference keeps one params tree with every per-layer leaf stacked on
a leading ``[L, ...]`` axis (``transformer._stacked_layers``, for
``lax.scan``).  The port runs its layer loop in Python, so its params are

    {"embed": [V_pad, d], "ln_f": {...}, "layers": [layer_0, ..., layer_L-1]}

with one dict of tensors per layer (the reference's per-layer subtree,
unstacked); an encoder-decoder's ``enc_layers`` unstack the same way,
while the hybrid's ``shared`` block is one unstacked dict in both
layouts.  Prequantized ``{"q", "s"}`` weight leaves unstack the same
way.  :func:`to_reference_layout` is the inverse: what an artifact bundle
and a checkpoint store, so the files the port writes are the reference's
format.  The optimizer state (``{"mu", "nu", "step"}``, the moments
shaped like the params) converts both ways with
:func:`opt_state_to_reference_layout` and :func:`as_port_opt_state`.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# the stacked per-layer roots -> the config field that counts them
_STACKS = {"layers": "n_layers", "enc_layers": "n_enc_layers"}


def from_jax_params(cfg, params_np, device="cuda") -> dict:
    """Reference params tree (numpy leaves, stacked layers) -> the port's
    params (tensors on ``device``, lists of per-layer dicts)."""
    out = {k: _map(v, lambda a: _to_tensor(a, device))
           for k, v in params_np.items() if k not in _STACKS}
    for root, field in _STACKS.items():
        if root not in params_np:
            continue
        stacked = params_np[root]
        n = _leading_dim(stacked)
        if cfg is not None and n != getattr(cfg, field):
            raise ValueError(f"params stack {n} {root}, config has "
                             f"{getattr(cfg, field)}")
        out[root] = [_map(stacked, lambda a, i=i: _to_tensor(np.asarray(a)[i],
                                                           device))
                     for i in range(n)]
    return out


def _leading_dim(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.asarray(tree).shape[0])


def params_to(params: dict, device="cuda") -> dict:
    """The port's params with every tensor moved to ``device``."""
    def move(t):
        return t.to(device) if isinstance(t, torch.Tensor) else t
    return {k: ([_map(lp, move) for lp in v] if isinstance(v, list)
                else _map(v, move)) for k, v in params.items()}


def as_port_params(cfg, params, device) -> dict:
    """Either layout (reference stacked numpy tree, or the port's) -> the
    port's params on ``device``."""
    if isinstance(params.get("layers"), dict):
        return from_jax_params(cfg, params, device)
    return params_to(params, device)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def to_reference_layout(params: dict) -> dict:
    """The port's params (tensors, lists of per-layer dicts, ``{"q", "s"}``
    leaves included) -> the reference's tree: numpy leaves, every
    per-layer leaf stacked on a leading [L, ...] axis.  A tree already
    stacked only turns into numpy."""
    return {k: (_stack([_map(lp, _to_numpy) for lp in v])
                if isinstance(v, list) else _map(v, _to_numpy))
            for k, v in params.items()}


def opt_state_to_reference_layout(state: dict) -> dict:
    """The port's AdamW state -> the reference's: both moment trees
    stacked (:func:`to_reference_layout`), ``step`` a numpy int32."""
    return {"mu": to_reference_layout(state["mu"]),
            "nu": to_reference_layout(state["nu"]),
            "step": _to_numpy(state["step"]).astype(np.int32)}


def as_port_opt_state(cfg, state: dict, device) -> dict:
    """An AdamW state in either layout -> the port's on ``device``: the
    moments as :func:`as_port_params`, ``step`` a 0-d int32 tensor."""
    step = np.asarray(_to_numpy(state["step"]), np.int32)
    return {"mu": as_port_params(cfg, state["mu"], device),
            "nu": as_port_params(cfg, state["nu"], device),
            "step": torch.from_numpy(step).to(device)}
