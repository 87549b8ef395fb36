"""The train step and the host training loop.

Port of ``repro/training/train_loop.py``. The loss and its grads come
from ``torch.autograd.grad`` over every floating parameter; the AdamW
step then writes the parameters and moments in place, and the grads are
dropped with the step. The training state's parameters are the model's
with ``window`` (the attention families' per-layer sliding windows) as an
(L,) f32 tensor, as in the reference's tree: it is a leaf the optimizer
updates like any other (its grad is zero, so only the weight decay moves
it, as in the reference).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw,
                                            tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def trainable(params, grad: bool = True):
    """The model's parameters as a training state holds them: ``window``
    (a list of floats) as an (L,) f32 tensor on the parameters' device and,
    with ``grad``, every floating leaf requiring grad. In place on the
    dict; returns it."""
    if isinstance(params.get("window"), list):
        dev = params["embed"].device
        params["window"] = torch.tensor(params["window"], dtype=torch.float32,
                                        device=dev)
    if grad:
        for p in tree_leaves(params):
            if p.is_floating_point():
                p.requires_grad_(True)
    return params


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data/pipeline.py``) -> tensors on ``device``."""
    return {k: v if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params, batch):
    """-> (``lm_loss`` detached, its grads: a tree of ``params``' structure).
    A leaf that requires no grad, or that no loss path reaches
    (``window``), gets a zero grad."""
    loss = M.lm_loss(params, cfg, batch)
    diff = [p for p in tree_leaves(params) if p.requires_grad]
    got = dict(zip(map(id, diff), torch.autograd.grad(loss, diff,
                                                      allow_unused=True)))

    def grad(p):
        g = got.get(id(p))
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad, params)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss,
    its grads, one AdamW step in place; the grads are freed with the step.
    ``metrics`` ("loss", "lr", "grad_norm") are device scalars; nothing is
    read back."""

    def train_step(state: TrainState, batch):
        loss, grads = loss_and_grads(cfg, state.params, batch)
        params, opt, om = adamw_update(opt_cfg, grads, state.opt,
                                       state.params)
        return TrainState(params=params, opt=opt), {"loss": loss, **om}

    return train_step


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Random parameters (``model.init_params``) and zero moments on
    ``device`` (default ``cuda``)."""
    params = trainable(M.init_params(cfg, generator, resolve_device(device)))
    return TrainState(params=params, opt=init_adamw(params))


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, data_iter, steps: int,
          generator: Optional[torch.Generator] = None, log_every: int = 10,
          callback=None, device=None, state: Optional[TrainState] = None):
    """Single-host training loop over numpy batches from ``data_iter``:
    -> (state, history). Metrics are read back only at every
    ``log_every``-th step and the last (``history``; ``callback(step,
    metrics)``). ``state`` (default: ``init_train_state``) is trained in
    place."""
    dev = resolve_device(device)
    if state is None:
        state = init_train_state(cfg, generator, dev)
    step_fn = make_train_step(cfg, opt_cfg)
    history = []
    for i in range(steps):
        batch = batch_to_device(next(data_iter), dev)
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if callback:
                callback(i, m)
    return state, history
