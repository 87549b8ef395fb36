"""Sharding rules: a ``PartitionSpec`` for every parameter, serve-state,
batch and training-state leaf over the ('pod', 'data', 'model') mesh.
Port of ``repro/launch/sharding.py``, every rule kept:

  * batch dims           -> ('pod', 'data') where they divide, else replicated
  * qkv / up projections -> column-parallel (output dim on 'model')
  * out / down           -> row-parallel (input dim on 'model')
  * MoE experts          -> the expert axis on 'model' when E % model == 0,
                            else the d_ff dim (mixtral, E = 8)
  * embeddings, lm head  -> vocab on 'model'
  * wave-index stores    -> the kv-head axis on 'model' when it divides,
                            else the cluster axis
  * optimizer moments    -> their parameter's spec

The reference stacks layers into leading ``(L, ...)`` dims; the port's
leaves are per layer (lists), so every dim index counted from the front is
one lower here: a port spec equals the reference's with its leading entry
dropped. ``to_placements`` turns a spec into DTensor placements.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import CLUSTER_FIELDS
from repro_torch.launch.mesh import Mesh, PartitionSpec as P


def map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, NamedTuples and lists (a
    list index adds no name to the path); every other object is a leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


def batch_axes(mesh: Mesh, B: int):
    """Largest prefix of ('pod', 'data') that divides B."""
    if "pod" in mesh.axis_names:
        pod, data = mesh.shape["pod"], mesh.shape["data"]
        if B % (pod * data) == 0:
            return ("pod", "data")
        if B % data == 0:
            return ("data",)
        return None
    return ("data",) if B % mesh.shape["data"] == 0 else None


def _ndim(leaf) -> int:
    return leaf.ndim if isinstance(leaf, torch.Tensor) else 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_pspecs(cfg: ModelConfig, params, mesh: Mesh):
    """Specs of a parameter tree (``model.param_specs`` or real tensors);
    non-tensor leaves (the per-layer windows) are replicated."""
    mn = mesh.shape["model"]

    def rule(names, leaf):
        name = names[-1] if names else ""
        nd = _ndim(leaf)
        if nd == 0:
            return P()
        shape = leaf.shape
        if name == "embed":
            return P("model", None) if shape[0] % mn == 0 else P()
        if name == "lm_head":
            return P(None, "model") if shape[1] % mn == 0 else P()
        if "moe" in names:
            E = cfg.moe.num_experts
            if name in ("w_gate", "w_up"):
                return P("model", None, None) if E % mn == 0 \
                    else P(None, None, "model")
            if name == "w_down":
                return P("model", None, None) if E % mn == 0 \
                    else P(None, "model", None)
            return P()                                     # router
        spec = [None] * nd
        column = ("wq", "wk", "wv") if "attn" in names or "xattn" in names \
            else ("w_gate", "w_up", "wr", "wk", "wv", "wg", "ck", "in_proj",
                  "cr")
        row = ("wo",) if "attn" in names or "xattn" in names \
            else ("w_down", "wo", "cv", "out_proj")
        if name in column and shape[-1] % mn == 0:
            spec[-1] = "model"
        elif name in row and nd >= 2 and shape[-2] % mn == 0:
            spec[-2] = "model"
        elif name not in column + row:
            return P()                                     # norms, mixes, ...
        return P(*spec)

    return map_with_path(rule, params)


# ---------------------------------------------------------------------------
# serve state
# ---------------------------------------------------------------------------

def wave_layout(cfg: ModelConfig, mesh: Mesh) -> str:
    """'head' when the kv heads divide the model axis, else 'cluster'."""
    return "head" if cfg.attn and \
        cfg.attn.n_kv_heads % mesh.shape["model"] == 0 else "cluster"


def serve_state_pspecs(cfg: ModelConfig, state, mesh: Mesh, B: int):
    """Specs of a serve state's per-layer leaves: (B, H, M, ...) for the
    wave index, (B, H, S, hd) for dense caches, (B, H, hd, hd | N) for the
    recurrent matrices, (B, F, H, hd) for whisper's cross K/V."""
    mn = mesh.shape["model"]
    ba = batch_axes(mesh, B)
    layout = wave_layout(cfg, mesh)

    def rule(names, leaf):
        name = names[-1] if names else ""
        nd = _ndim(leaf)
        if nd == 0:
            return P()
        shape = leaf.shape
        spec = [None] * nd
        if shape[0] == B and ba is not None:
            spec[0] = ba
        if name in CLUSTER_FIELDS:
            if layout == "head" and shape[1] % mn == 0:
                spec[1] = "model"
            elif nd >= 3 and shape[2] % mn == 0:           # the cluster axis M
                spec[2] = "model"
        elif name in ("k", "v") and nd == 4:               # DenseCache
            if shape[1] % mn == 0:
                spec[1] = "model"
            elif shape[2] % mn == 0:                       # the sequence axis
                spec[2] = "model"
        elif name in ("ssm", "wkv") and nd == 4:
            if shape[1] % mn == 0:
                spec[1] = "model"
        return P(*spec)

    return map_with_path(rule, state)


# ---------------------------------------------------------------------------
# batches, training state
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, batch, mesh: Mesh):
    def rule(names, leaf):
        spec = [None] * _ndim(leaf)
        ba = batch_axes(mesh, leaf.shape[0]) if spec else None
        if ba is not None:
            spec[0] = ba
        return P(*spec)

    return map_with_path(rule, batch)


def train_state_pspecs(cfg: ModelConfig, train_state, mesh: Mesh):
    """TrainState(params, opt=AdamWState(step, mu, nu)): the moments follow
    their parameter's spec."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_loop import TrainState
    pp = param_pspecs(cfg, train_state.params, mesh)
    return TrainState(params=pp, opt=AdamWState(step=P(), mu=pp, nu=pp))


# ---------------------------------------------------------------------------
# per-device sizes, DTensor placements
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factor(spec: P, mesh: Mesh) -> int:
    """How many pieces ``spec`` cuts a leaf into over ``mesh``."""
    n = 1
    for entry in spec:
        for a in _axes(entry):
            n *= mesh.shape[a]
    return n


def per_device_bytes(tree, specs, mesh: Mesh) -> float:
    """Bytes of one device's share of ``tree``'s tensors under ``specs``."""
    total = 0.0

    def add(leaf, spec):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size() \
                / shard_factor(spec, mesh)

    _zip_leaves(add, tree, specs)
    return total


def _zip_leaves(fn, tree, specs):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _zip_leaves(fn, v, specs[k])
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            _zip_leaves(fn, getattr(tree, f), getattr(specs, f))
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            _zip_leaves(fn, v, s)
    else:
        fn(tree, specs)


def to_placements(spec: P, device_mesh):
    """DTensor placements of ``spec`` on a ``DeviceMesh`` with the mesh's
    axis names: per mesh dim, ``Shard(d)`` where tensor dim d is split over
    that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = device_mesh.mesh_dim_names
    out = []
    for a in names:
        dims = [d for d, entry in enumerate(spec) if a in _axes(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
