"""Carry parameters, training and serve state to and from the JAX
package's layout, as numpy.

The caller converts the JAX pytrees to numpy (``np.asarray`` per leaf); this
module needs no JAX. Stacked ``(L, ...)`` layer leaves are split per layer,
matching the port's per-layer lists, and stacked again on the way back
(``params_to_numpy``, ``train_state_to_numpy``: the layout of the
reference's checkpoints).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import DenseCache
from repro_torch.core.wave_index import ChunkedPrefill, WaveState
from repro_torch.models.encdec import EncDecServeState
from repro_torch.models.hybrid import HybridServeState
from repro_torch.models.mamba2 import Mamba2LayerState
from repro_torch.models.rwkv6 import RwkvLayerState
from repro_torch.models.transformer import PrefillChunkState, ServeState
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState, trainable


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (or array-like) -> tensor copy; ``bfloat16`` arrays (the
    ml_dtypes type JAX hands numpy, or its raw ``V2`` values as a file
    stores them) are carried bit for bit."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def layer_of(tree, i):
    """Entry ``i`` of every stacked (L, ...) leaf of a nested mapping."""
    if isinstance(tree, Mapping):
        return {k: layer_of(v, i) for k, v in tree.items()}
    return tree[i]


def _to_torch(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device) -> Dict[str, Any]:
    """JAX ``models/model.py::init_params`` pytree (numpy leaves) -> the port's
    parameters: stacked layer leaves split into per-layer dicts (``layers``;
    enc-dec: ``enc_layers`` and ``dec_layers``), unstacked subtrees (the
    hybrid's ``shared`` block) carried as they are, and ``window`` (the
    attention families) as a list of floats."""
    params = {k: tensor_from_numpy(tree[k], device)
              for k in ("embed", "final_norm", "lm_head", "enc_norm")
              if k in tree}
    depth = dict(layers=cfg.n_layers, dec_layers=cfg.n_layers,
                 enc_layers=cfg.encoder_layers)
    for k, n in depth.items():
        if k in tree:
            params[k] = [_to_torch(layer_of(tree[k], i), device)
                         for i in range(n)]
    if "shared" in tree:
        params["shared"] = _to_torch(tree["shared"], device)
    if "window" in tree:
        params["window"] = [float(w) for w in np.asarray(tree["window"])]
    return params


def wave_states_from_numpy(fields: Mapping[str, np.ndarray],
                           device) -> List[WaveState]:
    """Stacked (L, ...) WaveState leaves (a mapping by field name) ->
    one WaveState per layer."""
    n = len(fields["length"])
    return [WaveState(**{f: tensor_from_numpy(fields[f][i], device)
                         for f in WaveState._fields}) for i in range(n)]


def _kv_from_numpy(fields: Mapping[str, np.ndarray], device) -> List[Any]:
    """Stacked (L, ...) KV-state leaves by field name -> a DenseCache per
    layer when the fields are ``k``, ``v``, ``length`` (full runtime), else
    a WaveState per layer (retro runtime)."""
    if set(fields) == set(DenseCache._fields):
        n = len(fields["length"])
        return [DenseCache(*(tensor_from_numpy(fields[f][i], device)
                             for f in DenseCache._fields)) for i in range(n)]
    return wave_states_from_numpy(fields, device)


def _per_layer(cls, fields: Mapping[str, np.ndarray], device) -> list:
    """Stacked (L, ...) leaves of the NamedTuple ``cls`` by field name ->
    one ``cls`` per layer."""
    n = len(fields[cls._fields[0]])
    return [cls(*(tensor_from_numpy(fields[f][i], device)
                  for f in cls._fields)) for i in range(n)]


def serve_state_from_numpy(fields: Mapping[str, Any], device):
    """The reference's stacked serve state, as a mapping by field name
    (nested mappings for nested states), -> the port's serve state of the
    same family, told apart by its fields:

    * ``ServeState`` (attention families): the KV fields themselves;
    * rwkv6 (ssm): ``wkv``, ``x_tm``, ``x_cm`` -> a list of
      ``RwkvLayerState``;
    * hybrid: ``mamba`` (``ssm``, ``conv``) and ``attn_kv`` (KV fields) ->
      ``HybridServeState``;
    * audio: ``self_kv`` (KV fields), ``cross_k``, ``cross_v`` (L, B, F,
      Hkv, hd) -> ``EncDecServeState``."""
    if "wkv" in fields:
        return _per_layer(RwkvLayerState, fields, device)
    if "mamba" in fields:
        return HybridServeState(
            mamba=_per_layer(Mamba2LayerState, fields["mamba"], device),
            attn_kv=_kv_from_numpy(fields["attn_kv"], device))
    if "self_kv" in fields:
        cross = lambda a: [tensor_from_numpy(x, device) for x in a]
        return EncDecServeState(
            self_kv=_kv_from_numpy(fields["self_kv"], device),
            cross_k=cross(fields["cross_k"]), cross_v=cross(fields["cross_v"]))
    return ServeState(kv=_kv_from_numpy(fields, device))


def prefill_chunk_state_from_numpy(cache: Mapping[str, np.ndarray],
                                   wave: Mapping[str, Any],
                                   device) -> PrefillChunkState:
    """Stacked admission state -> per-layer lists. ``cache`` maps DenseCache
    fields; ``wave`` maps ChunkedPrefill fields, with ``state`` a mapping of
    WaveState fields."""
    n = len(cache["length"])
    caches = [DenseCache(*(tensor_from_numpy(cache[f][i], device) for f in DenseCache._fields))
              for i in range(n)]
    states = wave_states_from_numpy(wave["state"], device)
    waves = [ChunkedPrefill(state=states[i],
                            **{f: tensor_from_numpy(wave[f][i], device)
                               for f in ChunkedPrefill._fields if f != "state"})
             for i in range(n)]
    return PrefillChunkState(cache=caches, wave=waves)


def wave_state_to_numpy(state: WaveState) -> Dict[str, np.ndarray]:
    """One WaveState -> {field: numpy copy} (f32 for bf16 leaves); a copy,
    since the port updates states in place."""
    return {f: tensor_to_numpy(getattr(state, f)) for f in WaveState._fields}


def serve_state_to_numpy(state) -> Any:
    """A serve state of any family -> the reference's stacked layout as
    numpy copies (f32 for bf16 leaves): NamedTuples as mappings by field,
    per-layer lists stacked on a leading axis. A copy, since the port
    updates states in place."""
    if isinstance(state, list):
        parts = [serve_state_to_numpy(x) for x in state]
        if isinstance(parts[0], dict):
            return {f: np.stack([p[f] for p in parts]) for f in parts[0]}
        return np.stack(parts)
    if hasattr(state, "_fields"):
        return {f: serve_state_to_numpy(getattr(state, f))
                for f in state._fields}
    return tensor_to_numpy(state)



def tensor_to_numpy(t, bf16_bits: bool = False) -> np.ndarray:
    """A tensor (or a Python float) -> a numpy copy. bf16 becomes f32, or
    with ``bf16_bits`` its raw 2-byte values (numpy's ``V2``, as numpy
    stores the reference's bf16 arrays)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, np.float32)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bf16_bits:
            return t.view(torch.int16).numpy().view(np.dtype("V2")).copy()
        t = t.float()
    return t.numpy().copy()


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def params_to_numpy(params: Mapping[str, Any],
                    bf16_bits: bool = False) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the port's parameters (or a
    tree of their structure, e.g. AdamW moments) -> the reference's
    ``init_params`` pytree as numpy copies: per-layer lists stacked on a
    leading (L, ...) axis, ``window`` (a list of floats or a tensor) as an
    (L,) f32 array, bf16 leaves as ``tensor_to_numpy`` gives them."""
    def conv(v):
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return _stack([conv(x) for x in v])
        return tensor_to_numpy(v, bf16_bits)
    return {k: conv(v) for k, v in params.items()}


def train_state_to_numpy(state, bf16_bits: bool = False):
    """A ``TrainState`` -> the reference's ``TrainState`` layout as numpy:
    ``TrainState(params, AdamWState(step, mu, nu))`` with the trees of
    ``params_to_numpy``."""
    tree = lambda p: params_to_numpy(p, bf16_bits)
    opt = state.opt
    return TrainState(params=tree(state.params), opt=AdamWState(
        step=tensor_to_numpy(opt.step), mu=tree(opt.mu), nu=tree(opt.nu)))


def train_state_from_numpy(tree, cfg: ModelConfig, device):
    """The reference's ``TrainState`` (numpy leaves: ``params``, then
    ``opt`` with ``step``, ``mu``, ``nu``) -> the port's, its parameters
    set up for training (``train_loop.trainable``)."""
    params, opt = tree
    moments = lambda t: trainable(params_from_numpy(t, cfg, device),
                                  grad=False)
    return TrainState(
        params=trainable(params_from_numpy(params, cfg, device)),
        opt=AdamWState(step=tensor_from_numpy(
            np.asarray(opt[0], np.int32), device),
            mu=moments(opt[1]), nu=moments(opt[2])))
