"""The compiled decode stage: one decode step captured as a CUDA graph per
geometry and replayed.

Port-only counterpart of ``ServeEngine._decode_fns`` in
``repro/serving/engine.py``: the reference wraps ``apply_decode`` in one
``jax.jit`` with the serve state donated, compiled once per
``(batch_size, max_ctx)`` (the "decode" entry of ``SERVE_STAGES``, budget
``per_geometry``). Here a ``DecodeGraph`` holds one geometry's step — the
engine makes one per ``serve`` call, keyed ``(batch, max_ctx, impl,
runtime)``, and drops it with the call's state:

* on a CUDA state, the first ``step`` runs the decode step eagerly on a side
  stream (the warm-up: it builds and loads the kernels, sets their
  shared-memory limits and initialises the libraries outside the capture).
  That is a real step; its logits and state are the ones served. The step is
  then captured into a ``torch.cuda.CUDAGraph``. Capture runs no kernel, so
  the state does not advance. Every later ``step`` replays the graph. A
  capture error raises; nothing falls back to eager;
* on a CPU state, every ``step`` runs the same step eagerly (the caller's
  choice of device).

A graph replays at fixed addresses. So the step reads its tokens and active
mask from static buffers, writes its logits and greedy ids to static
outputs (the ids also into the token buffer, the next step's input), and
updates the state's own tensors in place: ``step`` raises if a state tensor
moved. A kernel wrapper's launch count is Python code: it counts the
warm-up's launches and the ones the capture records, and no replay's (a
caller that counts launches adds ``replays`` times the capture's).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)


def state_addresses(state) -> Tuple[int, ...]:
    """The ``data_ptr`` of every tensor of a serve state, in order."""
    return tuple(t.data_ptr() for t in _leaves(state))


class DecodeGraph:
    """One geometry's decode step, captured once and replayed (see the
    module docstring).

    ``fn(state, tokens, active) -> (logits (B, V), state)`` is one decode
    step that updates ``state`` in place; ``sample(logits) -> (B,) int32``
    the on-device sampler. ``tokens``: the (B,) int32 token buffer, which
    the caller writes in place (admissions) and the step overwrites with
    its ids. ``captures`` counts captures, ``replays`` replays."""

    def __init__(self, fn: Callable, sample: Callable, state,
                 tokens: torch.Tensor, key: Optional[tuple] = None):
        self.fn, self.sample, self.key = fn, sample, key
        self.state = state
        self.tokens = tokens
        self.active = torch.zeros(tokens.shape, dtype=torch.bool,
                                  device=tokens.device)
        self.addresses = state_addresses(state)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits = self.ids = None           # the graph's static outputs
        self.captures = self.replays = 0

    def _check(self, state, when: str):
        if state_addresses(state) != self.addresses:
            raise RuntimeError(f"a serve-state tensor moved {when}: the "
                               f"decode step must update the state in place")

    def _run(self):
        """The step on the static buffers (eager, or recorded in capture)."""
        logits, state = self.fn(self.state, self.tokens, self.active)
        self._check(state, "in the decode step")
        ids = self.sample(logits)
        self.tokens.copy_(ids)
        return logits, ids

    def step(self, active: np.ndarray, state=None):
        """One decode step with the (B,) bool host mask ``active``; returns
        the device ``(logits, ids)``. A replay's outputs are the graph's
        static tensors, overwritten by the next replay: copy them (on the
        same stream) before the next ``step``. ``state``: the caller's view
        of the state, checked to hold the captured tensors."""
        if state is not None:
            self._check(state, "between decode steps")
        host = torch.from_numpy(np.ascontiguousarray(active, dtype=bool))
        if self.tokens.device.type != "cuda":
            self.active.copy_(host)
            return self._run()
        # a pinned source: a pageable copy would wait for the queued work
        self.active.copy_(host.pin_memory(), non_blocking=True)
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        self.replays += 1
        return self.logits, self.ids

    def _warm_up_and_capture(self):
        dev = self.tokens.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits, ids = self._run()
        main.wait_stream(side)
        for t in (logits, ids):                 # allocated on the side stream
            t.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        # as ``torch.cuda.graph`` does, but a failed capture still ends the
        # capture and restores the caller's stream before it raises
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            graph.capture_begin()
            try:
                self.logits, self.ids = self._run()
            finally:
                graph.capture_end()
        self.graph = graph
        self.captures += 1
        return logits, ids
