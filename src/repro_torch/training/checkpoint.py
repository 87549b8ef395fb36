"""Checkpoints as ``arrays.npz`` + ``meta.json``, in the reference's layout.

Port of ``repro/training/checkpoint.py``. The leaves are written in the
order ``jax.tree.flatten`` gives the reference's tree (dict keys sorted,
NamedTuples in field order, per-layer leaves stacked ``(L, ...)``; for a
``TrainState``: the parameters, then ``opt.step``, ``opt.mu``,
``opt.nu``), bf16 leaves as their raw 2-byte values, as numpy stores the
reference's. So a checkpoint written by either package restores in the
other. The trees go through host copies (``interop.params_to_numpy``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.interop import (layer_of, params_to_numpy,
                                 tensor_from_numpy, tensor_to_numpy)


def to_numpy(tree, bf16_bits: bool = True):
    """A port tree (a ``TrainState`` or any NamedTuple / tuple of trees, a
    parameter dict, a tensor) -> the reference's layout as numpy."""
    if isinstance(tree, dict):
        return params_to_numpy(tree, bf16_bits)
    if isinstance(tree, tuple):
        conv = [to_numpy(t, bf16_bits) for t in tree]
        return type(tree)(*conv) if hasattr(tree, "_fields") else tuple(conv)
    return tensor_to_numpy(tree, bf16_bits)


def flatten(tree) -> List[np.ndarray]:
    """The leaves of a numpy tree in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in flatten(t)]
    return [tree]


def _unflatten(template, it):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], it) for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        return [_unflatten(t, it) for t in template]
    return next(it)


def _fill(like, a):
    """``like``'s structure (a port tree) filled from ``a`` (the
    reference's layout of it), each tensor on its leaf's device and in its
    dtype."""
    if isinstance(like, torch.Tensor):
        return tensor_from_numpy(a, like.device).to(like.dtype) \
            .requires_grad_(like.requires_grad)
    if isinstance(like, dict):
        return {k: _fill(v, a[k]) for k, v in like.items()}
    if isinstance(like, tuple):
        vals = [_fill(l, x) for l, x in zip(like, a)]
        return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)
    if isinstance(like, list):      # per-layer entries of a stacked leaf
        return [float(a[i]) if isinstance(l, float)
                else _fill(l, layer_of(a, i)) for i, l in enumerate(like)]
    raise TypeError(f"not a checkpoint tree node: {type(like).__name__}")


def save(path: str, tree, step: int = 0, meta: Dict | None = None):
    os.makedirs(path, exist_ok=True)
    leaves = flatten(to_numpy(tree))
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": l for i, l in enumerate(leaves)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "treedef": type(tree).__name__,
                   "n_leaves": len(leaves), "meta": meta or {}}, f)


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (its leaf count and shapes
    are checked, its devices and dtypes kept)."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    template = to_numpy(like)
    leaves = flatten(template)
    assert len(leaves) == len(arrays), \
        f"checkpoint has {len(arrays)} leaves, expected {len(leaves)}"
    for a, l in zip(arrays, leaves):
        assert a.shape == l.shape, (a.shape, l.shape)
    return _fill(like, _unflatten(template, iter(arrays))), meta["step"]
