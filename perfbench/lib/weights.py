"""The benchmark's weights: seeded normals on the device, in the dtypes
they are served in, laid out as the system under test takes them.

The layout (the tree of names, shapes and dtypes) is read from the
program's ``param_specs`` on the meta device; the values are the
benchmark's own: one flat buffer per dtype, filled by a few large
``normal_`` calls from a ``torch.Generator`` on the device seeded with the
run's seed, then each matrix scaled in place by 1 / sqrt(fan_in) (its
second-to-last dimension: the input width of a projection, of each expert
and of the router), the token embedding by hidden_size^-0.5, and each norm
set to 0 (unit scale in the served layout). Both sides of the check read
these same tensors."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

CHUNK = 1 << 30             # elements per normal_ call


def _leaves(tree, path=()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and tree and \
            isinstance(tree[0], (dict, list, tuple, torch.Tensor)):
        return [x for i, t in enumerate(tree) for x in _leaves(t, path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def make(cfg, seed: int, device) -> Dict:
    """Seeded weights for the port's ``cfg`` on ``device``."""
    from repro_torch.models import model as M
    spec = M.param_specs(cfg)
    tree = _copy(spec)
    tensors = [(p, t) for p, t in _leaves(spec) if isinstance(t, torch.Tensor)]
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    by_dtype: Dict[torch.dtype, List] = {}
    for p, t in tensors:
        by_dtype.setdefault(t.dtype, []).append((p, t))
    for dtype, items in by_dtype.items():
        n = sum(t.numel() for _, t in items)
        flat = torch.empty(n, dtype=dtype, device=device)
        for i in range(0, n, CHUNK):
            flat[i:i + CHUNK].normal_(generator=gen)
        off = 0
        for p, t in items:
            w = flat[off:off + t.numel()].view(t.shape)
            off += t.numel()
            if t.dim() == 1:
                w.zero_()
            elif p == ("embed",):
                w.mul_(cfg.d_model ** -0.5)
            else:
                w.mul_(1.0 / math.sqrt(t.shape[-2]))
            _set(tree, p, w)
    return tree
