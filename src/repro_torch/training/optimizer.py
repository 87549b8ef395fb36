"""AdamW + cosine schedule + global-norm clipping over the port's
parameter trees (dicts and per-layer lists of tensors).

Port of ``repro/training/optimizer.py``, with its numerics: the grads cast
to f32 and clipped by their global norm, f32 moments, the bias corrections
``1 - b ** step`` in f32, the update in f32 and then cast to the
parameter's dtype, no master copy. Where the reference returns new trees,
``adamw_update`` writes the parameters, the moments and the step counter
in place (under ``torch.no_grad()``), so a step holds one copy of each;
the returned trees are its arguments. The step reads nothing back to the
host: the schedule and the metrics are device scalars.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (keys sorted, as ``jax.tree`` orders
    them), lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return []


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure (dicts, lists, tuples, NamedTuples)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    raise TypeError(f"not a parameter tree node: {type(tree).__name__}")


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any                 # f32, the structure of the parameters
    nu: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_adamw(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                       requires_grad=False)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_frac``
    of it; f32 on the step's device."""
    step = step.float()
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """-> (params, state, {"lr", "grad_norm"}), the parameters, moments and
    step updated in place. ``grads`` has the structure of ``params``; each
    is cast to f32 and clipped a leaf at a time (no f32 copy of the whole
    tree)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    state.step.add_(1)
    step = state.step.float()
    lr = cosine_lr(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)

    def upd(p, g, m, n):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        n.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        delta = (m / bc1).div_((n / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        delta.add_(pf, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(pf - delta)
        return p

    tree_map(upd, params, grads, state.mu, state.nu)
    metrics: Dict[str, torch.Tensor] = {"lr": lr, "grad_norm": gnorm}
    return params, state, metrics
