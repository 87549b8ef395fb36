"""The compiled decode stage: one decode step captured as a CUDA graph per
geometry and replayed.

Port-only counterpart of ``ServeEngine._decode_fns`` in
``repro/serving/engine.py``: the reference wraps ``apply_decode`` in one
``jax.jit`` with the serve state donated, compiled once per
``(batch_size, max_ctx)`` (the "decode" entry of ``SERVE_STAGES``, budget
``per_geometry``). Here a ``DecodeGraph`` holds one geometry's step — the
engine's direct store makes one per ``serve`` call, keyed ``(batch,
max_ctx, impl, runtime)``, and drops it with the call's state:

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
mask from static buffers, writes its logits and sampled ids to static
outputs (the ids also into the token buffer, the next step's input), and
updates the state's own tensors in place: ``step`` raises if a state tensor
moved. A kernel wrapper's launch count is Python code: it counts the
warm-up's launches and the ones the capture records, and no replay's (a
caller that counts launches adds ``replays`` times the capture's).

``OffloadStage`` is the offload step's counterpart (``_offload_fns`` of the
reference, the "embed_tokens", "rank_fn", "attend_fn", "unembed_logits",
"cache_upd" and "cache_stage" entries of ``SERVE_STAGES``): the layer-split
step of the host-offload plane as ``L + 1`` pieces, each captured as one
CUDA graph, with the host control plane running between their replays (see
its docstring).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.models import model as M
from repro_torch.models.transformer import LIVE_FIELDS


def leaves(tree):
    """Every tensor of a serve state, in order: the state NamedTuples of
    every family and their per-layer lists are walked as tuples, dicts (the
    offload plane's live fields) by their values."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from leaves(t)


def state_addresses(state) -> Tuple[int, ...]:
    """The ``data_ptr`` of every tensor of a serve state, in order."""
    return tuple(t.data_ptr() for t in leaves(state))


class DecodeGraph:
    """One geometry's decode step, captured once and replayed (see the
    module docstring).

    ``fn(state, tokens, active) -> (logits (B, V), state)`` is one decode
    step that updates ``state`` in place; ``sample(logits) -> (B,) int32``
    the on-device sampler (a generator it draws from, ``engine.Sampler``'s
    at a temperature, is registered with the graph: each replay draws
    fresh numbers). ``tokens``: the (B,) int32 token buffer, which
    the caller writes in place (admissions) and the step overwrites with
    its ids. ``captures`` counts captures, ``replays`` replays."""

    # the SERVE_STAGES entries this graph captures (rule RL103)
    STAGES = ("decode",)

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
            with spans.host("capture"):
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
        torch.cuda.synchronize(dev)
        self.graph, (self.logits, self.ids) = capture(
            torch.cuda.Stream(dev), self._run, gens=generators(self.sample))
        self.captures += 1
        return logits, ids


def generators(sample) -> Tuple[torch.Generator, ...]:
    """The random generator a sampler draws from (``engine.Sampler`` at a
    temperature), to register with the graph that captures it."""
    gen = getattr(sample, "generator", None)
    return () if gen is None else (gen,)


def capture(stream, run: Callable, pool=None, gens=()):
    """Capture ``run()`` on ``stream`` into a new CUDA graph (memory from
    ``pool`` when given): as ``torch.cuda.graph`` does, but a failed capture
    still ends the capture and restores the caller's stream before it
    raises. ``gens``: the generators ``run`` draws from, registered with
    the graph, so that each replay draws the next numbers of their streams
    (their offsets advance by the graph's draws a replay). Returns
    ``(graph, run's result)``."""
    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        graph.register_generator_state(gen)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = run()
        finally:
            graph.capture_end()
    return graph, out


# ---------------------------------------------------------------------------
# the compiled offload stage
# ---------------------------------------------------------------------------

def _scatter_rows(ck, cv, cp, ids, rows) -> None:
    """Write packed f32 payload rows ``[K | V | pos]`` (N, D) into one
    layer's device block cache at ``ids`` (3, N) int64 [row, head, slot]."""
    b, h, s = ids
    n, (cap, hd) = rows.shape[0], ck.shape[3:]
    ck[b, h, s] = rows[:, :cap * hd].reshape(n, cap, hd).to(ck.dtype)
    cv[b, h, s] = rows[:, cap * hd:2 * cap * hd].reshape(n, cap, hd) \
        .to(cv.dtype)
    cp[b, h, s] = rows[:, 2 * cap * hd:].to(cp.dtype)


def offload_cache_update(ck, cv, cp, adm_ids, adm_rows, miss_ids, miss_rows,
                         C: int) -> None:
    """One layer's block-cache update of the offload step, in place, on
    fixed-size inputs: the previous step's deferred admissions written into
    [0, C), then the staging tail [C, ...) emptied (K/V 0, pos -1) and this
    step's fetched misses written into it.

    ``*_ids``: (3, N) int64 [row, head, slot] and ``*_rows``: (N, D) f32
    packed rows, N fixed for the geometry. Padding entries name the cache's
    dead slot, its last (``ck.shape[2] - 1``, past the C + r slots that ids
    can point at): a padded write lands there and nowhere else, so one
    captured update serves every count, 0 included. It replaces the
    reference's two jitted variants (``cache_upd`` with admissions queued,
    ``cache_stage`` without) and their out-of-range ``mode="drop"`` ids."""
    _scatter_rows(ck, cv, cp, adm_ids, adm_rows)
    ck[:, :, C:].zero_()
    cv[:, :, C:].zero_()
    cp[:, :, C:].fill_(-1)
    _scatter_rows(ck, cv, cp, miss_ids, miss_rows)


class OffloadStage:
    """The offload decode step of one geometry on static buffers, run as
    ``L + 1`` pieces with the host control plane between them:

    * piece 0: embed the tokens, rank layer 0, copy its retrieved ids to the
      host;
    * piece l + 1 (l < L): layer l's cache update (``offload_cache_update``),
      its attend half, then layer l + 1's rank half and the copy of its ids
      to the host (for the last layer: unembed, sample, ids into the token
      buffer).

    Between piece l and piece l + 1 the caller (``_OffloadPlane.decode_step``)
    waits for layer l's ids, translates them, loads the translated slot ids
    and fetched rows (``load``), and after piece l + 1 drains layer l's
    admissions: the reference's pipelined order.

    The pieces run eagerly until ``capture_pieces``: after an eager step
    on the card (the warm-up: it builds the kernels and allocates the
    static outputs) it captures each piece into its own CUDA graph, all
    from one memory pool, in the order they replay (capture runs no
    kernel: the state does not advance); every later step replays them. A
    capture error raises; nothing falls back to eager. The offload plane's
    ``decode_step`` captures after its first step; on the CPU every step
    runs the same pieces eagerly.

    Fixed addresses: the hidden state, the rank's outputs (query,
    estimation inputs, retrieval cover: one set, shared by the layers), the
    active mask, one pinned host buffer for the retrieved ids, the staging
    buffers (device and pinned host) of the (2, B, H, r) slot/valid ids and
    the padded (3, N) admission and miss ids, and the device's (2, N, D)
    admission and miss rows, N = B·H·r (their host rows are the caller's:
    ``load``). The state (its live
    fields), the block caches and the token buffer are the caller's, bound
    by ``bind`` and checked to keep their addresses once captured; a rank
    half that rebinds a live field raises. The logits and ids, which no
    later piece reads, are the last piece's outputs: an eager step's own
    tensors, and once captured the graph's, fixed and overwritten by every
    replay.

    Stream order keeps the shared host buffers safe: the host writes layer
    l's staging only after its wait for layer l's ids, which the device
    writes after the previous piece, and so after that piece's reads of
    the staging; it reads layer l's ids before it launches the piece that
    overwrites them. Only the rows filled are copied to the device; the
    rest of a row buffer is stale and is read only by padding entries.
    ``captures`` counts captures, ``replays`` replayed steps."""

    # the SERVE_STAGES entries these pieces capture (rule RL103)
    STAGES = ("embed_tokens", "rank_fn", "attend_fn", "unembed_logits",
              "cache_upd", "cache_stage")

    def __init__(self, cfg, params, plan, attn_impl: str, caches, C: int, *,
                 sample: Callable, key: Optional[tuple] = None):
        self.cfg, self.params, self.plan = cfg, params, plan
        self.attn_impl, self.sample, self.key = attn_impl, sample, key
        (self._embed, self._rank, self._attend, self._unembed,
         _) = M.offload_decode_fns(cfg)
        self.cache_k, self.cache_v, self.cache_p = caches
        self.C, self.L = C, cfg.n_layers
        ck = self.cache_k[0]
        B, H, n_slots, cap, hd = ck.shape
        self.dead = n_slots - 1
        self.shape = (B, H, plan.r)
        self.N = N = B * H * plan.r
        D = 2 * cap * hd + cap
        dev = ck.device
        pin = dev.type == "cuda"

        def host(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.h_active = host((B,), torch.bool)
        # [slot/valid (2N) | admission ids (3N) | miss ids (3N)]
        self.ints = torch.zeros((8 * N,), dtype=torch.int32, device=dev)
        self.h_ints = host((8 * N,), torch.int32)
        self.rows = torch.zeros((2, N, D), dtype=torch.float32, device=dev)
        self.h_ids = host(self.shape, torch.int64)
        self.x = self.ctx = self.logits = self.ids = None   # warm-up allocs
        self.state = self.tokens = self.lives = None
        self.event = torch.cuda.Event() if pin else None
        self.graphs: Optional[List[torch.cuda.CUDAGraph]] = None
        self._captured: Optional[Tuple[int, ...]] = None
        self.captures = self.replays = 0

    # ------------------------------------------------------------ binding
    def addresses(self, state=None, tokens=None) -> Tuple[int, ...]:
        """The ``data_ptr`` of every tensor the pieces read or write
        across pieces or steps."""
        state = self.state if state is None else state
        tokens = self.tokens if tokens is None else tokens
        own = [self.active, self.h_active, self.ints, self.h_ints, self.rows,
               self.h_ids, self.x,
               *(self.ctx or ()), tokens,
               *self.cache_k, *self.cache_v, *self.cache_p]
        return state_addresses(state) + tuple(
            t.data_ptr() for t in own if t is not None)

    def bind(self, state, tokens: torch.Tensor) -> None:
        """Step ``state`` with the (B,) int32 ``tokens`` buffer. Before the
        capture any state may be bound; after it, only the captured one."""
        if self.graphs is not None:
            if self.addresses(state, tokens) != self._captured:
                raise RuntimeError("a tensor the offload stage captured "
                                   "moved between decode steps: the state, "
                                   "caches and buffers must stay in place")
            return
        self.state, self.tokens = state, tokens
        self.lives = [{f: getattr(st, f) for f in LIVE_FIELDS}
                      for st in state.kv]

    # ------------------------------------------------------------- pieces
    @staticmethod
    def _keep(buf, t):
        """``t`` into the static ``buf`` (allocated by the warm-up)."""
        if buf is None:
            return t.clone()
        buf.copy_(t)
        return buf

    def _rank_half(self, l: int) -> None:
        live = self.lives[l]
        ctx, idx_r, new = self._rank(
            self.params["layers"][l], self.params["window"][l], self.cfg,
            live, self.x, plan=self.plan, active=self.active)
        if any(new[f].data_ptr() != live[f].data_ptr() for f in LIVE_FIELDS):
            raise RuntimeError(f"layer {l}'s live state moved in the rank "
                               f"half: it must update the state in place")
        q, est_logit, cs_e, vs_e, cover = ctx
        flat = (q, est_logit, cs_e, vs_e, *cover)
        self.ctx = [self._keep(b, t)
                    for b, t in zip(self.ctx or [None] * len(flat), flat)]
        # the ids' copy into pinned memory, waited for by ``wait_ids``
        self.h_ids.copy_(idx_r, non_blocking=True)  # retrolint: sync(async id copy)

    def cache_update(self, l: int) -> None:
        """Layer ``l``'s block-cache update from the staged (``load``)
        admissions and misses."""
        adm, miss = self.ints[2 * self.N:].view(2, 3, self.N).long()
        offload_cache_update(self.cache_k[l], self.cache_v[l],
                             self.cache_p[l], adm, self.rows[0], miss,
                             self.rows[1], self.C)

    def _piece(self, k: int) -> None:
        """Piece ``k`` of the step on the static buffers."""
        if k == 0:
            self.x = self._keep(self.x, self._embed(self.params, self.cfg,
                                                    self.tokens))
            self._rank_half(0)
            return
        l = k - 1
        self.cache_update(l)
        sv = self.ints[:2 * self.N].view((2,) + self.shape)
        q, est_logit, cs_e, vs_e, *cover = self.ctx
        x = self._attend(
            self.params["layers"][l], self.params["window"][l], self.cfg,
            self.lives[l], self.x, (q, est_logit, cs_e, vs_e, tuple(cover)),
            self.cache_k[l], self.cache_v[l], self.cache_p[l], sv[0], sv[1],
            plan=self.plan, attn_impl=self.attn_impl)
        self.x.copy_(x)
        if l + 1 < self.L:
            self._rank_half(l + 1)
            return
        # the outputs: an eager step's own tensors; a captured piece's are
        # the graph's, at fixed addresses, overwritten by every replay
        self.logits = self._unembed(self.params, self.cfg, self.x)
        self.ids = self.sample(self.logits)
        self.tokens.copy_(self.ids)

    # ----------------------------------------------------------- the step
    def set_active(self, active: np.ndarray) -> int:
        """Load the (B,) host mask of decoding rows; returns its bytes."""
        self.h_active.numpy()[:] = active
        self.active.copy_(self.h_active, non_blocking=True)
        return self.h_active.numel()

    def run(self, k: int) -> None:
        """Piece ``k``: replayed once captured, else run eagerly; an event
        behind it marks the ids it copies to the host."""
        if self.graphs is not None:
            self.graphs[k].replay()
            self.replays += k == 0
        else:
            self._piece(k)
        if self.event is not None:
            self.event.record()

    def wait_ids(self) -> np.ndarray:
        """The (B, H, r) retrieved ids of the last piece's rank half."""
        if self.event is not None:
            self.event.synchronize()  # retrolint: sync(per-layer id readback)
        return self.h_ids.numpy()  # retrolint: sync(the awaited ids)

    def load(self, slots_valid: np.ndarray, adm, miss) -> int:
        """Stage one layer's inputs for the next piece: the (2, B, H, r)
        slot ids and validity, the deferred admissions and the fetched
        misses (each ((3, n) [row, head, slot] ids, (n, D) host rows) or
        None; the rows are copied from where they lie, which the caller
        keeps until the copy is done, pinned on the card). The ids are copied
        whole, padded with entries that name the dead slot, the rows as far
        as they are filled. Returns the bytes copied to the device."""
        N = self.N
        ints = self.h_ints.numpy()
        ints[:2 * N] = slots_valid.reshape(-1)
        srcs = (adm, miss)
        for i, src in enumerate(srcs):
            ids = ints[(2 + 3 * i) * N:(5 + 3 * i) * N].reshape(3, N)
            ids[:2] = 0
            ids[2] = self.dead
            if src is not None:
                n = src[0].shape[1]
                if n > N:
                    raise RuntimeError(f"{n} rows for a staging of {N}")
                ids[:, :n] = src[0]
        self.ints.copy_(self.h_ints, non_blocking=True)
        nbytes = self.h_ints.numel() * 4
        for i, src in enumerate(srcs):
            if src is not None and src[0].shape[1]:
                rows = torch.as_tensor(src[1])
                self.rows[i, :len(rows)].copy_(rows, non_blocking=True)
                nbytes += rows.numel() * 4
        return nbytes

    def capture_pieces(self) -> None:
        """Capture the pieces, once, after an eager step on the card; from
        then on ``bind`` holds the caller to the state and token buffer
        bound now. Take that step's logits and ids first: ``logits`` and
        ``ids`` become the graph's outputs, written by the first replay. A
        no-op once captured and on the CPU."""
        if self.graphs is not None or self.active.device.type != "cuda":
            return
        dev = self.active.device
        with spans.host("capture"):
            torch.cuda.synchronize(dev)
            stream = torch.cuda.Stream(dev)
            pool = torch.cuda.graph_pool_handle()
            graphs = []
            for k in range(self.L + 1):        # the last piece samples
                graph, _ = capture(stream, lambda: self._piece(k), pool,
                                   generators(self.sample) if k == self.L
                                   else ())
                graphs.append(graph)
        self.graphs = graphs
        self._captured = self.addresses()
        self.captures += 1
