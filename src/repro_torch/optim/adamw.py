"""AdamW with schedules and global-norm clipping — counterpart of
``repro/optim/adamw.py``.

A plain function on the port's params tree (a dict of tensors whose
``"layers"`` entry is a list of per-layer dicts), not a ``torch.optim``
subclass, so that every operation lines up with the reference's: the
gradient norm is taken before clipping, the step is incremented, the bias
corrections come from the incremented step, and each leaf's update is
``mhat / (sqrt(nhat) + eps) + wd * p`` in f32.  The state is a pair of
params-shaped trees (``mu``, ``nu``) and an int32 ``step`` tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"       # constant|cosine|linear
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------------
# The params tree: dicts and lists of tensors
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), keeping its dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# Schedule, state, norm
# ---------------------------------------------------------------------------

def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device.  Dividing by it keeps the
    IEEE quotient: PyTorch divides by a Python number (and divides a
    Python number by a tensor) through a reciprocal on some devices."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup then constant, linear or cosine decay to ``min_lr_frac``,
    in f32 as the reference computes it."""
    step = step.float()
    warm = torch.clamp_max(step / _f32(max(cfg.warmup_steps, 1), step), 1.0)
    span = _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "linear":
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0, 1)
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:  # cosine
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0, 1)
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_state(params) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` and ``step`` 0 (int32), on the
    params' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda t: tree_map(torch.zeros_like, t)
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def _clip(grads, norm: torch.Tensor, max_norm: float):
    scale = torch.clamp_max(_f32(max_norm, norm) / torch.clamp_min(norm, 1e-9),
                            1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so that their global norm is at most ``max_norm``,
    and the norm before scaling."""
    norm = global_norm(grads)
    return _clip(grads, norm, max_norm), norm


def apply_updates(cfg: AdamWConfig, params, grads, state,
                  norm_fn: Callable = global_norm
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new params, new state, {"lr",
    "grad_norm"}); the inputs are left as they were.  ``norm_fn(grads)``
    is the global norm that clipping uses (a sharded step passes one that
    sums over the ranks' shards)."""
    with torch.no_grad():
        gnorm = norm_fn(grads)
        if cfg.clip_norm is not None:
            grads = _clip(grads, gnorm, cfg.clip_norm)

        step = state["step"] + 1
        lr = schedule_lr(cfg, step)
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = 1 - _f32(b1, step) ** step.float()
        bc2 = 1 - _f32(b2, step) ** step.float()

        def upd(p, g, mu, nu):
            g = g.float()
            p32 = p.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mhat = mu / bc1
            nhat = nu / bc2
            delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
            return (p32 - lr * delta).to(p.dtype), mu, nu

        out = [upd(p, g, m, n) for p, g, m, n in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state["mu"]), tree_leaves(state["nu"]))]
        new_p = tree_unflatten(params, [o[0] for o in out])
        new_state = {"mu": tree_unflatten(params, [o[1] for o in out]),
                     "nu": tree_unflatten(params, [o[2] for o in out]),
                     "step": step}
    return new_p, new_state, {"lr": lr, "grad_norm": gnorm}
