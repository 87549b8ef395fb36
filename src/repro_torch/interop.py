"""Carry parameters and state across from the JAX package, as numpy.

The caller converts the JAX pytrees to numpy (``np.asarray`` per leaf); this
module needs no JAX. Stacked ``(L, ...)`` layer leaves are split per layer,
matching the port's per-layer lists.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import DenseCache
from repro_torch.core.wave_index import ChunkedPrefill, WaveState
from repro_torch.models.transformer import PrefillChunkState, ServeState


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (or array-like) -> tensor copy; ``bfloat16`` arrays (the
    ml_dtypes type JAX hands numpy) are carried bit for bit."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layer(tree, i):
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _to_torch(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device) -> Dict[str, Any]:
    """JAX ``models/model.py::init_params`` pytree (numpy leaves) -> the port's
    parameters: per-layer dicts, and ``window`` as a list of floats."""
    params = {k: tensor_from_numpy(tree[k], device)
              for k in ("embed", "final_norm", "lm_head") if k in tree}
    params["layers"] = [_to_torch(_layer(tree["layers"], i), device)
                        for i in range(cfg.n_layers)]
    params["window"] = [float(w) for w in np.asarray(tree["window"])]
    return params


def wave_states_from_numpy(fields: Mapping[str, np.ndarray],
                           device) -> List[WaveState]:
    """Stacked (L, ...) WaveState leaves (a mapping by field name) ->
    one WaveState per layer."""
    n = len(fields["length"])
    return [WaveState(**{f: tensor_from_numpy(fields[f][i], device)
                         for f in WaveState._fields}) for i in range(n)]


def serve_state_from_numpy(fields: Mapping[str, np.ndarray],
                           device) -> ServeState:
    """Stacked (L, ...) serve-state leaves by field name -> ServeState: a
    WaveState per layer (retro runtime), or a DenseCache per layer when the
    fields are ``k``, ``v``, ``length`` (full runtime)."""
    if set(fields) == set(DenseCache._fields):
        n = len(fields["length"])
        return ServeState(kv=[
            DenseCache(*(tensor_from_numpy(fields[f][i], device)
                         for f in DenseCache._fields)) for i in range(n)])
    return ServeState(kv=wave_states_from_numpy(fields, device))


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
    out = {}
    for f in WaveState._fields:
        t = getattr(state, f)
        t = t.float() if t.dtype == torch.bfloat16 else t
        out[f] = t.detach().cpu().numpy().copy()
    return out
