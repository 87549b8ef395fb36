"""Continuous-batching serving engine with chunked or blocking admission
and a decode loop that reads ids back once per step, one step late.
Serves every family: the attention families (dense, moe, vlm) under both
admissions; ssm, hybrid and audio admit blocking only (recurrent prefills
and the enc-dec decoder consume a prompt in one pass, unpadded), as in the
reference.

Port of ``repro/serving/engine.py``: both serve runtimes ("retro", the wave
index; "full", a dense KV cache), both admission modes, every
decode-attention impl, the direct store and the host-offload plane, and
its sampling: greedy, or at ``temperature`` > 0 Gumbel-max from a
generator seeded by ``serve(seed)`` (``Sampler``).

The decode loop runs a fixed number of slots. Under chunked admission (the
default) a request's prompt is consumed one fixed-size chunk per scheduler
iteration, interleaved between decode steps; when its last chunk is in, the
finalized single-slot state is grafted into the batch state. Blocking
admission prefills a free slot's whole prompt (right-padded to a multiple
of ``prefill_bucket``) in one pass before the next decode step; configs
with block-sparse prefill always admit this way. The full runtime reads the
whole dense cache each step, as the reference's compiled step does. On the
card each decode step after a run's first replays captured CUDA graphs of
one geometry (``serving/graphs.py``, the counterpart of the reference's
per-geometry ``jax.jit``): one graph per direct-store step, one per offload
layer piece; the CPU runs the same steps eagerly. First tokens
of all requests admitted in the same iteration are sampled on device and
read back with one coalesced copy.
Decode sampling stays on device: step t's ids are copied to pinned host
memory behind an event and harvested after step t+1 has been enqueued, so
completion is detected one step late (the speculative extra token of a
finished request is dropped). Staging-buffer flushes are per-row masked.

Host-offload mode (``offload=True``, paper Sec. 4.3): the cluster payload
stores live on the host behind one ``WaveBufferBatch`` per layer (the
wave buffers of every slot and kv head, as stacked arrays), and decode
attention reads a per-layer device block cache through cache-slot ids:
hits from the cache, misses fetched from the host into a per-step staging
tail, cache admissions deferred off the hot path. The decode loop
then reads the retrieved ids back once per layer (the paper's CPU control
plane), between the replays of the layer pieces. See ``_OffloadPlane``.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import resolve_attn_impl
from repro_torch.core.wave_batch import WaveBufferBatch
from repro_torch.core.wave_buffer import (BufferStats, FaultProfile,
                                          FaultyTransport, LinkTransport)
from repro_torch.core.wave_index import local_buffer_size
from repro_torch.core.zones import plan_zones
from repro_torch.models import model as M
from repro_torch.models.transformer import (LIVE_FIELDS, ServeState,
                                            refuse_ring, torch_dtype)
from repro_torch.serving.graphs import DecodeGraph, OffloadStage, leaves


@dataclass
class Request:
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    # per-request prefill extras, (1, ...) tensors or arrays: for vlm
    # {"patch_embeds": (1, P, D)}, for audio {"frames": (1, F, D)} (the
    # stubbed frontend's frame embeddings), handed to every prefill call of
    # the request
    extra: Optional[Dict] = None
    # ---- filled by the engine ----
    ttft_s: float = 0.0                 # enqueue -> first token
    decode_tps: float = 0.0             # this request's decode tokens/s
    # "ok" | "timeout" (watchdog) | "error" (unrecoverable link fault)
    status: str = "ok"
    slot: int = -1                      # decode slot that served it


@dataclass
class ServeMetrics:
    """Aggregate serve metrics over real requests only."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    prefill_tokens: int = 0
    steps: int = 0                      # decode steps executed
    flushes: int = 0                    # per-row masked index updates run
    occupied_slot_steps: int = 0
    n_slots: int = 0
    ttft_s: List[float] = field(default_factory=list)
    # gaps between consecutive token deliveries of continuing requests
    step_s: List[float] = field(default_factory=list)
    # host-offload wave-buffer counters, summed over every per-row buffer
    # (retired ones included); zero unless the engine runs with offload
    cache: BufferStats = field(default_factory=BufferStats)
    # degraded decode: steps with >= 1 cluster masked out of the retrieval
    # zone (its fetch failed), and the cluster-step drop count
    degraded_steps: int = 0
    dropped_cluster_steps: int = 0
    # the call's spans (``repro_torch.spans``) when the engine records them
    spans: Optional[spans.Spans] = None
    # the share layers' rows over the decode steps (``moe.share_apply``):
    # token-expert pairs routed to the experts held here (active rows), and
    # rows their fixed-capacity buffers computed; counted on the device in
    # the captured step, read once at the call's end
    moe_rows_routed: int = 0
    moe_rows_computed: int = 0

    @property
    def decode_tps(self) -> float:
        return self.tokens_out / max(self.decode_s, 1e-9)

    # -- the wave-buffer counters, read from ``cache``
    @property
    def cache_lookups(self) -> int:
        return self.cache.lookups

    @property
    def cache_hits(self) -> int:
        return self.cache.hits

    @property
    def cache_pending_hits(self) -> int:
        return self.cache.pending_hits

    @property
    def bytes_over_link(self) -> int:
        return self.cache.bytes_over_link

    @property
    def bytes_from_cache(self) -> int:
        return self.cache.bytes_from_cache

    @property
    def bytes_from_pending(self) -> int:
        return self.cache.bytes_from_pending

    @property
    def cache_faults(self) -> int:
        return self.cache.faults

    @property
    def cache_retries(self) -> int:
        return self.cache.retries

    @property
    def cache_corrupt_fetches(self) -> int:
        return self.cache.corrupt_fetches

    @property
    def cache_failed_fetches(self) -> int:
        return self.cache.failed_fetches

    @property
    def cache_hit_ratio(self) -> float:
        return self.cache.hit_ratio

    @property
    def effective_cache_hit_ratio(self) -> float:
        """Counts pending hits (repeat misses served without a second link
        transfer) as hits."""
        return self.cache.effective_hit_ratio

    @property
    def prefill_tps(self) -> float:
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def slot_occupancy(self) -> float:
        return self.occupied_slot_steps / max(self.steps * self.n_slots, 1)

    @property
    def itl_p50_s(self) -> float:
        return float(np.percentile(self.step_s, 50)) if self.step_s else 0.0

    @property
    def itl_p99_s(self) -> float:
        return float(np.percentile(self.step_s, 99)) if self.step_s else 0.0


# ---------------------------------------------------------------------------
# Stage contract, consumed by the port's retrolint (``repro_torch.analysis``);
# the counterpart of the reference's ``SERVE_STAGES``, with the same stage
# names, effects, memory spaces and numerics contract. Per stage:
#   * ``fn``: the callable that runs it, "module:attribute" (a method's
#     ``self`` is argument 0); stages that share one callable are told
#     apart by the trace pass (``analysis/stage_check.py``: ``_route``);
#   * ``donate``: the positional arguments the stage updates IN PLACE (what
#     the port does where the reference donates): every tensor of them keeps
#     its address and is written (rule RL102), and no other argument is
#     written;
#   * ``budget``: CUDA graph captures over a serve run (rule RL103):
#       "per_geometry": captured once per serve geometry by the graph that
#                       owns it (``graphs.DecodeGraph`` / ``OffloadStage``:
#                       their ``STAGES``); the CPU runs it eagerly
#       "eager":        run eagerly, never captured (admission, flushes,
#                       first-token sampling)
#       "host":         a control-plane step of the offload plane (no device
#                       work; a schedule event only)
#   * ``copy_ok``: arguments a fresh same-shaped output does not copy (RL104);
#   * ``effects`` / ``space``: the abstract buffers it reads, writes, donates
#     or passes through, for the happens-before checker (RL301-RL305:
#     ``analysis/schedule_model.py``), as in the reference;
#   * ``numerics``: the f32 contract of every device stage (RL401-RL405).
# ---------------------------------------------------------------------------
_ENGINE, _MODEL, _GRAPHS, _TF = ("repro_torch.serving.engine",
                                 "repro_torch.models.model",
                                 "repro_torch.serving.graphs",
                                 "repro_torch.models.transformer")
SERVE_STAGES: Dict[str, Dict[str, Any]] = {
    "graft":           dict(donate=(0,), budget="eager", space="device",
                            fn=f"{_ENGINE}:graft",
                            effects=dict(reads=("serve_state", "slot_state"),
                                         writes=("serve_state",),
                                         donates=("serve_state",))),
    "argmax_ids":      dict(donate=(), budget="eager", space="device",
                            fn=f"{_ENGINE}:Sampler.__call__",
                            effects=dict(reads=("logits",),
                                         writes=("tokens",))),
    "categorical_ids": dict(donate=(), budget="eager", space="device",
                            fn=f"{_ENGINE}:Sampler.__call__",
                            effects=dict(reads=("logits",),
                                         writes=("tokens",))),
    "merge_tokens":    dict(donate=(0,), budget="eager", space="device",
                            fn=f"{_ENGINE}:merge_tokens",
                            effects=dict(reads=("tokens",),
                                         writes=("tokens",))),
    # admission
    "prefill":         dict(donate=(), budget="eager", space="device",
                            fn=f"{_MODEL}:apply_prefill",
                            effects=dict(reads=("prompt",),
                                         writes=("slot_state",))),
    "chunk":           dict(donate=(3,), budget="eager", space="device",
                            fn=f"{_MODEL}:apply_prefill_chunk",
                            effects=dict(reads=("prompt", "chunk_state"),
                                         writes=("chunk_state",),
                                         donates=("chunk_state",))),
    "chunk_pe":        dict(donate=(3,), budget="eager", space="device",
                            fn=f"{_MODEL}:apply_prefill_chunk",
                            effects=dict(reads=("prompt", "chunk_state"),
                                         writes=("chunk_state",),
                                         donates=("chunk_state",))),
    # finalize clusters the staged tail into the chunk state's wave index,
    # in place, and returns it as the single-row serve state that ``graft``
    # then copies into the batch state
    "fin":             dict(donate=(1,), budget="eager", space="device",
                            fn=f"{_MODEL}:finalize_prefill_chunk",
                            effects=dict(reads=("serve_state",
                                                "chunk_state"),
                                         writes=("serve_state",
                                                 "slot_state"),
                                         donates=("serve_state",))),
    # direct-store decode
    "decode":          dict(donate=(2,), budget="per_geometry",
                            space="device", fn=f"{_MODEL}:apply_decode",
                            effects=dict(reads=("tokens", "serve_state"),
                                         writes=("logits", "serve_state"),
                                         donates=("serve_state",))),
    "flush":           dict(donate=(1,), budget="eager", space="device",
                            fn=f"{_MODEL}:flush_state",
                            effects=dict(reads=("serve_state",),
                                         writes=("serve_state",),
                                         donates=("serve_state",))),
    # host-offload decode plane (the device stream: ``OffloadStage``)
    "embed_tokens":    dict(donate=(), budget="per_geometry", space="device",
                            fn=f"{_TF}:decode_embed",
                            effects=dict(reads=("tokens",),
                                         writes=("hidden",))),
    "rank_fn":         dict(donate=(3,), budget="per_geometry",
                            space="device", fn=f"{_TF}:offload_decode_rank",
                            effects=dict(reads=("hidden", "live[l]"),
                                         writes=("ctx[l]", "ids[l]",
                                                 "live[l]"),
                                         donates=("live[l]",))),
    "attend_fn":       dict(donate=(), budget="per_geometry", space="device",
                            fn=f"{_TF}:offload_decode_attend",
                            effects=dict(reads=("hidden", "ctx[l]",
                                                "live[l]", "cache_body[l]",
                                                "cache_tail[l]", "slots[l]",
                                                "valid[l]"),
                                         writes=("hidden",))),
    "unembed_logits":  dict(donate=(), budget="per_geometry", space="device",
                            fn=f"{_TF}:decode_unembed",
                            effects=dict(reads=("hidden",),
                                         writes=("logits",))),
    # one captured update (``graphs.offload_cache_update``) serves both of
    # the reference's variants: with admissions queued (cache_upd) and
    # without (cache_stage); the staging tail is overwritten wholesale, so
    # it is not a data read; the body IS (the scatter keeps other slots)
    "cache_upd":       dict(donate=(0, 1, 2), budget="per_geometry",
                            space="device",
                            fn=f"{_GRAPHS}:offload_cache_update",
                            effects=dict(reads=("cache_body[l]",
                                                "adm_queue[l]", "miss[l]"),
                                         writes=("cache_body[l]",
                                                 "cache_tail[l]"),
                                         donates=("cache_body[l]",
                                                  "cache_tail[l]"))),
    # cache_stage writes only the staging tail; the body rides through
    # (``passes``), which keeps RL305 from treating it as clobbered
    "cache_stage":     dict(donate=(0, 1, 2), budget="per_geometry",
                            space="device",
                            fn=f"{_GRAPHS}:offload_cache_update",
                            effects=dict(reads=("miss[l]",),
                                         writes=("cache_tail[l]",),
                                         donates=("cache_body[l]",
                                                  "cache_tail[l]"),
                                         passes=("cache_body[l]",))),
    "offload_flush":   dict(donate=(1,), budget="eager", space="device",
                            fn=f"{_TF}:offload_flush",
                            effects=dict(reads=("live[*]",),
                                         writes=("live[*]", "flush_blocks"),
                                         donates=("live[*]",))),
    # host control plane of the offload decode step (schedule events traced
    # through _OffloadPlane.trace)
    "readback_start":  dict(donate=(), budget="host", space="host",
                            effects=dict(reads=("ids[l]",))),
    "readback_ids":    dict(donate=(), budget="host", space="host",
                            effects=dict(reads=("ids[l]",),
                                         writes=("ids_host[l]",))),
    # translate also builds the per-cluster validity mask (valid[l], link
    # space): 0 marks a miss whose fetch failed this step
    "translate":       dict(donate=(), budget="host", space="host",
                            effects=dict(reads=("ids_host[l]", "cmt[l]",
                                                "host_store[l]",
                                                "pending[l]"),
                                         writes=("slots[l]", "miss[l]",
                                                 "valid[l]", "pending[l]",
                                                 "cmt[l]"))),
    "drain_admissions": dict(donate=(), budget="host", space="host",
                             effects=dict(reads=("pending[l]",
                                                 "host_store[l]"),
                                          writes=("cmt[l]", "pending[l]",
                                                  "adm_queue[l]"))),
    "readback_flush":  dict(donate=(), budget="host", space="host",
                            effects=dict(reads=("flush_blocks",))),
    "host_flush":      dict(donate=(), budget="host", space="host",
                            effects=dict(writes=("host_store[*]",))),
    "admit_slot":      dict(donate=(), budget="host", space="host",
                            effects=dict(writes=("host_store[*]", "cmt[*]",
                                                 "pending[*]",
                                                 "adm_queue[*]"))),
}

# The numerics contract of every device stage (rules RL401-RL405,
# ``analysis/numerics_check.py``): exp/log/LSE chains in f32 (softmax),
# matmuls with f32 outputs (accum), and no narrowing but the stage's output
# and same-dtype store writes ("output-only"; "free" opts a stage out).
NUMERICS_F32: Dict[str, str] = dict(softmax="float32", accum="float32",
                                    narrow="output-only")
for _contract in SERVE_STAGES.values():
    if _contract["space"] == "device":
        _contract.setdefault("numerics", NUMERICS_F32)
del _contract


@dataclass
class _Admission:
    """One slot's admission: a chunked one in progress, or a finished
    blocking prefill (its logits)."""
    req: Request
    rid: int                            # the request's index in the queue
    cstate: Any = None                  # PrefillChunkState
    consumed: int = 0
    logits: Any = None                  # device logits of the last chunk
    extra: Dict = field(default_factory=dict)   # ``req.extra`` on the device


class _Readback:
    """Device (B,) ids copied into the (pinned, for a CUDA device) host
    buffer ``host`` without blocking; ``get`` waits for that copy only (not
    for work enqueued after it)."""

    def __init__(self, ids: torch.Tensor, host: torch.Tensor):
        self.host, self.event = host, None
        host.copy_(ids, non_blocking=True)
        if ids.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()  # retrolint: sync(lagged id harvest)
        return self.host.numpy()  # retrolint: sync(the awaited ids)


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor without blocking the host: a pageable
    copy would wait for all work queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()            # never alias the caller's host array


def _extras(req: Request, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A request's prefill extras as device tensors (numpy arrays are
    copied over; tensors are moved where they lie elsewhere)."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))).to(dev) for k, v in (req.extra or {}).items()}


def graft(big, small, slot: int):
    """Copy the single-row serve state ``small`` into row ``slot`` of the
    batch state ``big``, in place (the reference donates ``big``). Every
    leaf of every family's state has its batch axis first."""
    for b, s in zip(leaves(big), leaves(small), strict=True):
        b[slot:slot + 1].copy_(s)
    return big


def merge_tokens(tokens: torch.Tensor, upd: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The admitted rows' first tokens ``upd`` into the (B,) token buffer
    where ``mask``, in place (the buffer is the captured step's input)."""
    return tokens.copy_(torch.where(mask, upd, tokens))


def _pack(k, v, p):
    """Device blocks -> packed f32 payload rows ``[K | V | pos]``:
    (..., m, cap, hd) x2 + (..., m, cap) -> (..., m, 2 cap hd + cap). Exact
    for bf16/f32 stores and integer positions."""
    lead = k.shape[:-2]
    return torch.cat([k.float().reshape(lead + (-1,)),
                      v.float().reshape(lead + (-1,)), p.float()], -1)


class _DirectStore:
    """One direct-store ``serve`` call's KV placement, with the offload
    plane's interface: the batch state on the device, stepped by one
    ``DecodeGraph`` of ``apply_decode`` and the call's sampler (the only
    place that composes the two). A share layer adds its row counts into
    ``moe_counts`` in the step. The step holds no reference to the store or
    the engine: no cycle keeps a dropped engine's state alive."""

    def __init__(self, cfg: ModelConfig, params, plan, state,
                 tokens: torch.Tensor, sample, *, runtime: str,
                 attn_impl: str, key: Optional[tuple] = None):
        self.cfg = cfg
        self.failed_slots: Dict[int, str] = {}      # always empty
        self.moe_counts = moe_counts = torch.zeros(
            (2,), dtype=torch.int64, device=tokens.device) \
            if cfg.moe is not None and cfg.moe.share else None

        def fn(st, tokens, active):
            return M.apply_decode(params, cfg, st, tokens, runtime=runtime,
                                  plan=plan, active=active,
                                  attn_impl=attn_impl, moe_counts=moe_counts)
        self.graph = DecodeGraph(fn, sample, state, tokens, key=key)

    def admit_slot(self, i: int, st1) -> None:
        """Nothing to place: ``graft`` copied the slot's row on the device."""

    def decode_step(self, state, tokens_dev, active):
        """The graph's step (its token buffer is ``tokens_dev``)."""
        return self.graph.step(active, state)

    def flush(self, state, rows):
        return M.flush_state(self.cfg, state)

    def export_stats(self, metrics: "ServeMetrics") -> None:
        if self.moe_counts is not None:
            metrics.moe_rows_routed, metrics.moe_rows_computed = \
                self.moe_counts.tolist()  # retrolint: sync(share-layer row counts, once a call)

    def kept(self):
        """The engine's ``last_graph`` and ``last_plane``."""
        return self.graph, None


class _OffloadPlane:
    """Host control plane of one offload ``serve`` call (paper Sec. 4.3).

    The cluster PAYLOAD stores live on the host over packed f32 payload
    rows ``[K | V | pos]`` (the reference's layout: exact for bf16/f32
    stores and integer positions, so cache placement is bit-transparent),
    behind one ``WaveBufferBatch`` per layer: the wave buffers of every
    (slot, kv-head) row as stacked arrays, translated and drained for the
    whole layer at once. The device keeps, per layer, a block cache of
    ``C + r + 1`` slots: slots [0, C) hold each row's cached clusters (the
    only copy: the host keeps no mirror), the tail r slots stage the step's
    misses and the last is a dead slot that only padded writes reach. Each
    decode step runs per layer:

      rank (device) -> id readback -> translate ids through the mapping
      tables (hits -> cache slots, misses -> staging slots, miss payloads
      gathered from the host stores straight into the layer's pinned
      staging) -> cache update (device: the previous step's deferred
      admissions + this step's misses) -> attend (device, slot-addressed)
      -> drain (host, off the hot path: victims chosen, tables updated;
      the admitted rows reach the device cache at the next step's cache
      update).

    Layer-pipelined as in the reference: right after layer l's attend is
    enqueued, layer l+1's rank is enqueued and its id copy started (a pinned
    buffer behind an event); only then does layer l's admission drain run
    on the host, so the id wait overlaps the drain. The device work runs
    through an ``OffloadStage`` (``serving/graphs.py``): ``L + 1`` pieces on
    static buffers, run eagerly until ``decode_step`` captures them after
    its first step on the card, replayed as CUDA graphs after (``step``
    runs them as they stand and never captures).
    Host->device traffic is the active mask, the translated slot ids and
    validity mask and the padded admission / miss ids, and only the payload
    rows that change the cache (fetched misses, admissions): the staging
    tail is reset on the device, then the fetched rows are written at their
    slots, which leaves the same cache as the reference's whole-tail
    restage. Every layer attends with the mask and the retrieval cover, as
    the reference does, so a row's logits never depend on another row's
    faults. Every dispatch / host op / sync calls ``trace`` (a no-op), in
    the reference's program order. The host's time per piece is in spans
    (``repro_torch.spans``, while a recorder is active): ``decode_step``
    and per layer ``readback_ids`` (the id wait), ``translate``, ``stage``
    (the next piece's inputs), ``launch`` (a replay, or the eager enqueue;
    piece 0 at layer -1) and ``drain_admissions``; ``admit_slot`` over per
    layer ``admit_copy`` (pack and device-to-host copy) and ``admit_crc``
    (the stores' checksums and fresh tables); ``offload_flush`` and
    ``host_flush``. ``counts`` holds the steps, the bytes copied to the
    device, the fresh miss rows fetched by the layer-wide gather
    (``gathered_rows``) and one transport ``fetch`` at a time
    (``per_miss_rows``: a transport other than the production one), and the
    layers' payload rows checksummed at admission, store and gather by the
    native routine (``native_crc_rows``) or, on a host without its fold, by
    ``zlib`` (``zlib_crc_rows``).

    A layer's fetched rows stay in its own pinned staging until the next
    step's cache update has sent its admissions. Each layer has two, used
    by alternate steps: the copies out of one (its misses at its own step's
    cache update, its admissions at the next step's) are enqueued before
    the layer's rank two steps on, whose ids the host waits for before it
    gathers into that staging again. Admissions that are the staging's
    first k rows, in order (every fetched row fresh and admitted), are sent
    from there; others are first copied out of it.
    """

    def trace(self, op: str, layer: int, kind: str, step: int,
              **extras) -> None:
        """Schedule-event hook, one call per dispatch / host op / sync in
        program order; a no-op."""

    def __init__(self, cfg: ModelConfig, params, plan, B: int, max_ctx: int,
                 *, attn_impl: str, sample, placement: "KVPlacement", device):
        self.dev = torch.device(device)
        self.L, self.B, self.H = cfg.n_layers, B, cfg.n_kv_heads
        self.M = plan.m_max
        self.r = max(plan.r, 1)             # staging tail (dead slot if r=0)
        self.C = placement.cache_slots(self.M)
        C, r, cap, dev = self.C, self.r, cfg.retro.cluster_cap, self.dev
        # slot C + r: the dead slot of the stage's padded cache writes
        self.cache_k = [torch.zeros((B, self.H, C + r + 1, cap, cfg.head_dim),
                                    dtype=torch_dtype(cfg), device=dev)
                        for _ in range(self.L)]
        self.cache_v = [torch.zeros_like(c) for c in self.cache_k]
        self.cache_p = [torch.full((B, self.H, C + r + 1, cap), -1,
                                   dtype=torch.int32, device=dev)
                        for _ in range(self.L)]
        self.ncl = np.zeros(B, np.int64)    # host mirror of n_clusters
        self.retired = BufferStats()        # stats of replaced slot caches
        self._step = -1                     # schedule epoch for trace events
        # ONE transport per plane, shared by every buffer: the control plane
        # is single-threaded, so a seeded FaultyTransport yields one
        # reproducible fault schedule per serve
        self.transport = (FaultyTransport(placement.fault_profile)
                          if placement.fault_profile is not None
                          else LinkTransport())
        self.fetch_deadline_s = placement.fetch_deadline_s
        self.degraded_steps = 0             # steps with >= 1 masked cluster
        self.dropped_cluster_steps = 0      # cluster-step masked count
        self.failed_slots: Dict[int, str] = {}   # slot -> fatal fault message
        self._counts = dict(steps=0, h2d_bytes=0, gathered_rows=0,
                            per_miss_rows=0)
        self.cfg = cfg
        self._flush = M.offload_decode_fns(cfg)[-1]
        self.stage = OffloadStage(
            cfg, params, plan, attn_impl,
            (self.cache_k, self.cache_v, self.cache_p), C, sample=sample,
            key=(B, max_ctx, C, r, attn_impl))
        D = 2 * cap * cfg.head_dim + cap
        self.layers = [WaveBufferBatch(
            B, self.H, self.M, D, C, policy=placement.cache_policy,
            transport=self.transport, max_retries=placement.fetch_retries,
            backoff_s=placement.fetch_backoff_s) for _ in range(self.L)]
        # per layer, two (N, D) pinned stagings of fetched rows, used by
        # alternate steps (see the class docstring); ``host_rows`` is their
        # numpy view
        self.h_rows = torch.empty((self.L, 2, self.stage.N, D),
                                  dtype=torch.float32,
                                  pin_memory=dev.type == "cuda")
        self.host_rows = self.h_rows.numpy()
        # per-layer queued device mirror of deferred admissions, as host
        # ((3, n) [row, head, slot] ids, (n, D) rows); None = nothing queued
        self.pending_adm: List[Optional[Tuple[np.ndarray, torch.Tensor]]] = \
            [None] * self.L

    @property
    def counts(self) -> Dict[str, int]:
        """The call's counters (see the class docstring)."""
        return dict(self._counts,
                    native_crc_rows=sum(l.native_crc_rows
                                        for l in self.layers),
                    zlib_crc_rows=sum(l.zlib_crc_rows for l in self.layers))

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device, counted in ``counts["h2d_bytes"]``."""
        self._counts["h2d_bytes"] += a.nbytes
        return to_device(a, self.dev)

    # ----------------------------------------------------------- admission
    def admit_slot(self, i: int, st1) -> None:
        """Offload a freshly admitted request's cluster stores: slot ``i``'s
        payload blocks, packed on the device, copied to the host once per
        request; fresh mapping tables (the previous occupant's cache entries
        die with it; its stats are retired into the engine aggregate)."""
        self._step += 1
        self.trace("admit_slot", -1, "host", self._step)
        with spans.host("admit_slot", slot=i):
            self.ncl[i] = int(st1.kv[0].n_clusters[0])  # retrolint: sync(cluster-count mirror)
            for l in range(self.L):
                st = st1.kv[l]
                with spans.host("admit_copy", layer=l):
                    host = _pack(  # retrolint: sync(store offload)
                        st.k_store[0], st.v_store[0], st.pos_store[0]) \
                        .cpu().numpy()                          # (H, M, D)
                with spans.host("admit_crc", layer=l):
                    old = self.layers[l].admit(i, host)
                if old is not None:
                    self.retired.merge(old)
                self._drop_queued(l, i)

    def _drop_queued(self, l: int, i: int) -> None:
        """Drop layer ``l``'s queued admissions aimed at slot ``i``'s
        replaced caches."""
        if self.pending_adm[l] is not None:
            ids, rows = self.pending_adm[l]
            keep = ids[0] != i
            self.pending_adm[l] = (ids[:, keep],
                                   rows[torch.from_numpy(keep)])

    # ------------------------------------------------------- control plane
    def _translate(self, l, ids, active):
        """Cluster ids -> cache-slot ids; the miss payloads gathered into
        the layer's pinned staging (``WaveBufferBatch.translate``).

        Ids of not-yet-live clusters (>= the row's ``n_clusters`` mirror)
        never touch the wave buffer: fetching them would admit an
        all-masked payload that a later flush would turn into a stale hit.
        They map to their staging slot, whose empty payload (``pos = -1``)
        masks them as the direct path does.

        Returns ``(slots_valid, miss)``: ``slots_valid`` (2, B, H, r) int32
        holds the slot ids and the validity mask (0 marks a live cluster
        whose fetch failed its retries or deadline this step; the attend
        covers its mass with the estimation zone); ``miss`` is ``((3, n)
        [row, head, staging slot], the staging's first n rows)`` or None.
        A :class:`FatalTransportError` marks the whole slot failed
        (``failed_slots``); the serve loop finishes that request with
        ``status="error"``.
        """
        B, H, r = ids.shape
        sv = np.zeros((2, B, H, r), np.int32)
        sv[1] = 1
        if r == 0:      # steady-zone-only plan: attend pads its own dead slot
            return sv, None
        layer = self.layers[l]
        rows = active & layer.admitted
        rows[list(self.failed_slots)] = False
        par = self._counts["steps"] % 2
        tr = layer.translate(ids, rows, self.ncl, self.fetch_deadline_s,
                             self.host_rows[l, par])
        # a visited buffer's ids default to their staging slots. A fatal
        # fault kills only its row: the walk skips its later heads (slots
        # 0), its staged defaults self-mask, and the request finishes before
        # its token is harvested
        stage = self.C + np.arange(r)
        sv[0] = np.where(tr.slot >= 0, tr.slot,
                         np.where(tr.visited[..., None], stage, 0))
        sv[1] = ~tr.failed
        self.dropped_cluster_steps += int(tr.failed.sum())
        self.failed_slots.update(tr.fatal)
        self._counts["gathered_rows"] += tr.gathered
        self._counts["per_miss_rows"] += tr.per_miss
        if not tr.n:
            return sv, None
        mb, mh, mj = np.nonzero(tr.fetched)
        return sv, (np.stack([mb, mh, stage[mj]]),
                    self.h_rows[l, par, :tr.n])

    def _drain_admissions(self, l) -> bool:
        """Apply the layer's deferred admissions (off the attend hot path)
        and queue their device-cache mirror for the next step's cache
        update: the staging's first rows where they are its first k, else
        a copy of them. A warm step with no admission queues None, and the
        next update skips the mirror. Returns whether anything was
        queued."""
        adm = self.layers[l].drain()
        if adm is None:
            self.pending_adm[l] = None
            return False
        par, k = self._counts["steps"] % 2, len(adm.src)
        rows = self.h_rows[l, par, :k] if (adm.src == np.arange(k)).all() \
            else torch.from_numpy(self.host_rows[l, par][adm.src])
        self.pending_adm[l] = (np.stack([adm.rows, adm.heads, adm.slots]),
                               rows)
        return True

    # ------------------------------------------------------------- decode
    def decode_step(self, state, tokens_dev, active):
        """The serve loop's step: ``step``, then the stage's capture (after
        the first step on the card; a no-op after it and on the CPU)."""
        out = self.step(state, tokens_dev, active)
        self.stage.capture_pieces()
        return out

    def step(self, state, tokens_dev, active):
        """One decode step over the slot batch, layer-pipelined (see the
        class docstring), through the stage's pieces as they stand (eager
        until captured). The sampled ids are written into ``tokens_dev``.
        Returns the stage's device ``(logits, ids)``: an eager step's own
        tensors, once captured the graph's, which the next step
        overwrites; the state is updated in place."""
        self._step += 1
        t = self._step
        cn = self._counts
        cn["steps"] += 1
        drops_before = self.dropped_cluster_steps
        st = self.stage
        with spans.host("decode_step", step=t):
            st.bind(state, tokens_dev)
            with spans.host("launch", layer=-1):
                cn["h2d_bytes"] += st.set_active(active)
                self.trace("embed_tokens", -1, "dispatch", t)
                self.trace("rank_fn", 0, "dispatch", t)
                st.run(0)
                self.trace("readback_start", 0, "host", t)
            for l in range(self.L):
                # the paper's CPU control plane needs the retrieved ids on
                # the host; their copy was enqueued with the rank
                self.trace("readback_ids", l, "sync", t)
                with spans.host("readback_ids", layer=l):
                    ids = st.wait_ids()
                self.trace("translate", l, "host", t)
                with spans.host("translate", layer=l):
                    sv, miss = self._translate(l, ids, active)
                # the previous step's admissions (if any) mirror into
                # [0, C), this step's misses into the staging tail
                self.trace("cache_stage" if self.pending_adm[l] is None
                           else "cache_upd", l, "dispatch", t)
                with spans.host("stage", layer=l):
                    cn["h2d_bytes"] += st.load(sv, self.pending_adm[l], miss)
                self.trace("attend_fn", l, "dispatch", t)
                last = l + 1 == self.L
                if not last:        # pipeline: next rank before this drain
                    self.trace("rank_fn", l + 1, "dispatch", t)
                with spans.host("launch", layer=l):
                    st.run(l + 1)
                if not last:
                    self.trace("readback_start", l + 1, "host", t)
                # off the hot path
                with spans.host("drain_admissions", layer=l):
                    queued = self._drain_admissions(l)
                self.trace("drain_admissions", l, "host", t, queued=queued)
        # (run with the last layer's piece)
        self.trace("unembed_logits", -1, "dispatch", t)
        if self.dropped_cluster_steps > drops_before:
            self.degraded_steps += 1
        return st.logits, st.ids

    # -------------------------------------------------------------- flush
    def flush(self, state, rows):
        """Decode-time index update: meta entries on the device, payload
        blocks appended to the host stores at each flushed row's cluster
        offset (through ``store_rows``, which refreshes the checksums)."""
        self._step += 1                 # own schedule epoch (between steps)
        kv = state.kv
        lives = [{f: getattr(st, f) for f in LIVE_FIELDS} for st in kv]
        self.trace("offload_flush", -1, "dispatch", self._step)
        flushed = np.where(rows)[0]
        with spans.host("offload_flush", rows=len(flushed)):
            new_lives, res = self._flush(self.cfg, lives, self._h2d(rows))
            sel = self._h2d(flushed)
            self.trace("readback_flush", -1, "sync", self._step)
            blocks = torch.stack(  # retrolint: sync(flush blocks)
                [_pack(c.k_store, c.v_store, c.pos_store)[sel]
                 for c in res]).cpu().numpy()
        self.trace("host_flush", -1, "host", self._step)
        k_new = blocks.shape[3]                   # (L, rows, H, k_new, D)
        with spans.host("host_flush", rows=len(flushed)):
            for j, b in enumerate(flushed):
                off = int(self.ncl[b])
                for l in range(self.L):
                    if self.layers[l].stores[b] is not None:
                        self.layers[l].store_rows(b, off, blocks[l, j])
                self.ncl[b] += k_new
        return ServeState(kv=[st._replace(**nl)
                              for st, nl in zip(kv, new_lives)])

    # ------------------------------------------------------------- stats
    def export_stats(self, metrics: "ServeMetrics") -> None:
        metrics.cache.merge(self.retired)
        for layer in self.layers:
            metrics.cache.merge(layer.total())
        metrics.degraded_steps += self.degraded_steps
        metrics.dropped_cluster_steps += self.dropped_cluster_steps

    def kept(self):
        """The engine's ``last_graph`` and ``last_plane``."""
        return self.stage, self


@dataclass(frozen=True)
class KVPlacement:
    """Where a serve call's KV lives, decided in one place (``open``): on
    the device (``_DirectStore``), or with ``offload`` in host memory
    behind the offload plane's block cache (``_OffloadPlane``), which the
    other fields size and whose fetches they shape (``ServeEngine``'s
    keywords of the same names)."""
    offload: bool
    cache_clusters: int
    cache_frac: float
    cache_policy: str
    fault_profile: Optional[FaultProfile]
    fetch_deadline_s: Optional[float]
    fetch_retries: int
    fetch_backoff_s: float

    def check(self, cfg: ModelConfig, runtime: str) -> None:
        """Refuse an offload that the config or the runtime cannot serve."""
        if not self.offload:
            return
        refuse_ring(cfg, "host-offload serving", runtime)
        if not M.supports_offload(cfg, runtime):
            raise ValueError("host-offload serving requires the retro "
                             f"runtime on an attention family, got "
                             f"runtime={runtime!r} family={cfg.family!r}")

    def cache_slots(self, m_max: int) -> int:
        """Device block-cache slots: the absolute override or a fraction of
        the cluster-store size, clamped to [1, m_max]."""
        c = self.cache_clusters if self.cache_clusters > 0 \
            else int(self.cache_frac * m_max)
        return max(1, min(c, m_max))

    def open(self, cfg: ModelConfig, params, plan, state,
             tokens: torch.Tensor, sample, *, runtime: str, attn_impl: str,
             max_ctx: int):
        """One serve call's store over its batch state and token buffer."""
        B = tokens.shape[0]
        if self.offload:
            return _OffloadPlane(cfg, params, plan, B, max_ctx,
                                 attn_impl=attn_impl, sample=sample,
                                 placement=self, device=tokens.device)
        return _DirectStore(cfg, params, plan, state, tokens, sample,
                            runtime=runtime, attn_impl=attn_impl,
                            key=(B, max_ctx, attn_impl, runtime))


class Sampler:
    """On-device sampling of (B, V) f32 logits to (B,) int32 ids, no host
    transfer: the argmax at ``temperature`` <= 0; otherwise Gumbel-max,
    ``argmax(logits / T + g)`` with g = -log(-log(u)) and u uniform from
    ``generator`` (on the logits' device, seeded with ``seed``), a draw
    from ``softmax(logits / T)`` per row. The reference draws with
    ``jax.random.categorical`` (the same Gumbel-max) under a key split per
    admission round and decode step; the port draws from one generator
    stream, each call advancing it, so a seed fixes the tokens of a serve
    (not the reference's tokens: the two generators' bits differ). A
    captured decode step registers ``generator`` with its graph, so every
    replay draws fresh noise with no host sync."""

    def __init__(self, temperature: float = 0.0, seed: int = 0,
                 device="cpu"):
        self.temperature = float(temperature)
        self.generator = None if self.temperature <= 0 else \
            torch.Generator(device=device).manual_seed(seed)

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        if self.generator is None:
            return logits.argmax(dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self.generator,
                       device=logits.device)
        g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
        return (logits / self.temperature + g).argmax(dim=-1) \
            .to(torch.int32)


@dataclass
class _Call:
    """One ``serve`` call's scheduler state that its admission methods
    share: the queue of (rid, request), per slot its request, its chunked
    admission in progress and its decoding flag, the batch state, its
    store, and the call's metrics."""
    queue: deque
    slots: List[Optional[Request]]
    admitting: List[Optional[_Admission]]
    active: np.ndarray
    state: Any
    store: Any                          # _DirectStore | _OffloadPlane
    plan: Any
    max_ctx: int
    metrics: ServeMetrics


def _recorded(serve):
    """``serve`` inside a span recorder when the engine records spans; the
    records go into the returned metrics' ``spans``."""
    @functools.wraps(serve)
    def run(self, *args, **kwargs):
        if not self.spans:
            return serve(self, *args, **kwargs)
        with spans.recording(self.device) as rec:
            metrics = serve(self, *args, **kwargs)
        metrics.spans = rec
        return metrics
    return run


class ServeEngine:
    """``serve(requests, batch_size)`` — continuous scheduler over a slot
    batch. ``runtime``: "retro" (the wave index) or "full" (dense cache).
    ``max_context`` pins the decode geometry (zone plan, cluster-store
    capacity); a request's outputs do not depend on what shares the batch.
    ``admission``: "chunked" (``prefill_chunk`` tokens per scheduler
    iteration) or "blocking" (one prefill per request; ``prefill_bucket``
    > 1 right-pads prompts up to a multiple of it). ``attn_impl`` selects
    the decode-attention implementation ("jnp"
    reference, "fused" paged kernel, "pallas" gathered-buffer kernel); None
    defers to ``cfg.retro.attn_impl``. ``offload`` (None: the config's)
    serves with the cluster stores in host memory behind a device block
    cache of ``cache_clusters`` slots (or ``cache_frac`` of the store) under
    ``cache_policy``; ``fault_profile`` (a ``FaultProfile`` or a spec such
    as "transient=0.2,seed=3"), ``fetch_deadline_s``, ``fetch_retries`` and
    ``fetch_backoff_s`` shape its miss fetches. ``temperature`` > 0
    samples every token (``Sampler``, seeded by ``serve(seed=...)``); 0,
    the default, is greedy. ``spans`` records each call's spans
    (``repro_torch.spans``) into its ``ServeMetrics.spans``. ``device``
    defaults to ``cuda`` and raises when there is no card."""

    def __init__(self, cfg: ModelConfig, params, *, runtime: str = "retro",
                 gen_headroom: int = 1024, temperature: float = 0.0,
                 max_context: Optional[int] = None, prefill_bucket: int = 1,
                 admission: str = "chunked",
                 prefill_chunk: int = 256, attn_impl: Optional[str] = None,
                 offload: Optional[bool] = None,
                 cache_clusters: Optional[int] = None,
                 cache_frac: Optional[float] = None,
                 cache_policy: Optional[str] = None,
                 fault_profile: Optional[Any] = None,
                 fetch_deadline_s: Optional[float] = None,
                 fetch_retries: int = 2, fetch_backoff_s: float = 1e-3,
                 max_decode_steps: Optional[int] = None, spans: bool = False,
                 device=None):
        if admission not in ("chunked", "blocking"):
            raise ValueError(f"unknown admission mode {admission!r}")
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl or cfg.retro.attn_impl)
        self.cfg = cfg
        self.params = params
        self.runtime = runtime
        self.gen_headroom = gen_headroom
        self.temperature = temperature
        self.max_context = max_context
        self.prefill_bucket = max(1, prefill_bucket)
        self.admission = admission
        self.prefill_chunk = max(1, prefill_chunk)
        self.max_decode_steps = max_decode_steps
        retro = cfg.retro
        if isinstance(fault_profile, str):
            fault_profile = FaultProfile.parse(fault_profile)
        self.placement = KVPlacement(
            offload=retro.offload if offload is None else offload,
            cache_clusters=retro.cache_clusters if cache_clusters is None
            else cache_clusters,
            cache_frac=retro.cache_frac if cache_frac is None else cache_frac,
            cache_policy=cache_policy or retro.cache_policy,
            fault_profile=fault_profile, fetch_deadline_s=fetch_deadline_s,
            fetch_retries=fetch_retries, fetch_backoff_s=fetch_backoff_s)
        self.placement.check(cfg, runtime)
        if admission == "chunked" and M.supports_chunked_prefill(cfg, runtime):
            refuse_ring(cfg, "chunked admission", runtime)
        self.spans = spans

    def _bucket(self, L: int) -> int:
        """Blocking admission's prefill length for an L-token prompt: L
        rounded up to a multiple of ``prefill_bucket``; prompts shorter than
        sink + local are too short to mask a ragged tail and keep L, and so
        do the non-attention families (recurrent prefills consume pads)."""
        retro = self.cfg.retro
        if self.cfg.family not in M.ATTN_FAMILIES \
                or L < retro.sink + retro.local:
            return L
        b = self.prefill_bucket
        return L if b <= 1 else ((L + b - 1) // b) * b

    # ----------------------------------------------------------- admission
    def _admit_blocking(self, c: "_Call", i: int) -> Optional[_Admission]:
        """Blocking admission into slot ``i`` when it is free: the next
        request's whole prompt prefilled in one pass."""
        if c.active[i] or c.slots[i] is not None or not c.queue:
            return None
        cfg, dev = self.cfg, self.device
        rid, req = c.queue.popleft()
        L = len(req.prompt)
        with spans.host("admit", rid=rid, slot=i, tokens=L):
            S_b = min(self._bucket(L), c.max_ctx)
            toks = np.zeros((1, S_b), np.int32)
            toks[0, :L] = req.prompt
            batch = {"tokens": to_device(toks, dev), **_extras(req, dev)}
            # recurrent prefills take no ragged lengths (and _bucket never
            # pads them)
            lengths = to_device(np.array([L], np.int32), dev) \
                if cfg.family in M.ATTN_FAMILIES else None
            with spans.host("prefill"):
                logits, st1 = M.apply_prefill(
                    self.params, cfg, batch, runtime=self.runtime,
                    plan=c.plan, gen_headroom=self.gen_headroom,
                    lengths=lengths,
                    cache_len=c.max_ctx + self.gen_headroom)
            c.metrics.prefill_tokens += L
            return self._admitted(c, i, st1, _Admission(
                req=req, rid=rid, logits=logits, consumed=L))

    def _admit_chunked(self, c: "_Call", i: int) -> Optional[_Admission]:
        """Chunked admission in slot ``i``: one prefill chunk of its
        request (the next queued one, when the slot is free); the request's
        admission once its last chunk is in."""
        if c.admitting[i] is None and not c.active[i] \
                and c.slots[i] is None and c.queue:
            rid, req = c.queue.popleft()
            c.admitting[i] = _Admission(req=req, rid=rid)
        adm = c.admitting[i]
        if adm is None:
            return None
        cfg, dev, rt = self.cfg, self.device, self.runtime
        L, C = len(adm.req.prompt), self.prefill_chunk
        n = min(C, L - adm.consumed)
        with spans.host("admit", rid=adm.rid, slot=i, tokens=n):
            if adm.cstate is None:          # the request's first chunk
                adm.extra = _extras(adm.req, dev)
                adm.cstate = M.make_prefill_chunk_state(
                    cfg, 1, c.max_ctx, runtime=rt, chunk=C,
                    gen_headroom=self.gen_headroom, device=dev)
            toks = np.zeros((1, C), np.int32)
            toks[0, :n] = adm.req.prompt[adm.consumed:adm.consumed + n]
            with spans.host("chunk"):
                adm.logits, adm.cstate = M.apply_prefill_chunk(
                    self.params, cfg,
                    {"tokens": to_device(toks, dev), **adm.extra},
                    adm.cstate, runtime=rt,
                    chunk_lens=to_device(np.array([n], np.int32), dev))
            adm.consumed += n
            c.metrics.prefill_tokens += n
            if adm.consumed < L:
                return None
            with spans.host("fin"):
                st1 = M.finalize_prefill_chunk(cfg, adm.cstate, runtime=rt,
                                               total_len=L)
            adm.cstate = c.admitting[i] = None
            return self._admitted(c, i, st1, adm)

    @staticmethod
    def _admitted(c: "_Call", i: int, st1, adm: _Admission) -> _Admission:
        """Both admissions' tail: the single-row state ``st1`` grafted into
        row ``i`` of the batch state, then placed by the store."""
        with spans.host("graft"):
            c.state = graft(c.state, st1, i)
        c.store.admit_slot(i, st1)
        return adm

    # -------------------------------------------------------------- serve
    @_recorded
    @torch.inference_mode()
    def serve(self, requests: List[Request], batch_size: int,
              seed: int = 0) -> ServeMetrics:
        """Serve a FIFO queue through ``batch_size`` continuous slots. The
        decode state and its store (``KVPlacement.open``), with its
        captured step (``last_graph``: a ``DecodeGraph``, or with offload
        the plane's ``OffloadStage``), belong to this call: each call
        captures once, at its geometry. ``seed`` seeds the sampler
        (``temperature`` > 0): one seed, one token stream."""
        cfg, dev, rt = self.cfg, self.device, self.runtime
        if not requests:
            raise ValueError("no requests")
        max_ctx = self.max_context or max(self._bucket(len(r.prompt))
                                          for r in requests)
        min_len = cfg.retro.sink + 1 \
            if rt == "retro" and cfg.family != "ssm" else 1
        for r in requests:
            if not min_len <= len(r.prompt) <= max_ctx:
                raise ValueError(f"prompt length {len(r.prompt)} outside "
                                 f"[{min_len}, {max_ctx}]")
        B = batch_size
        # chunk attention is exact: configs that opt into block-sparse
        # prefill keep the monolithic (sparse) admission
        chunked = self.admission == "chunked" \
            and M.supports_chunked_prefill(cfg, rt) \
            and cfg.sparse_prefill_blocks == 0
        admit = self._admit_chunked if chunked else self._admit_blocking
        plan = plan_zones(max_ctx, cfg.retro, self.gen_headroom) \
            if cfg.family != "ssm" else None
        state = M.make_serve_state(cfg, B, max_ctx, runtime=rt,
                                   gen_headroom=self.gen_headroom,
                                   zero_fill=True, device=dev)
        lbuf = local_buffer_size(cfg.retro)
        use_flush = rt == "retro" and cfg.family != "ssm"
        # the step's token buffer: written in place, never rebound
        tokens_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        # the ids' host buffers, alternated: step t's are read after step
        # t + 1 is enqueued, and step t + 2 writes them after that read
        h_ids = [torch.zeros((B,), dtype=torch.int32,
                             pin_memory=dev.type == "cuda") for _ in range(2)]
        sample = Sampler(self.temperature, seed, dev)
        store = self.placement.open(cfg, self.params, plan, state, tokens_dev,
                                    sample, runtime=rt,
                                    attn_impl=self.attn_impl, max_ctx=max_ctx)
        queue = deque(enumerate(requests))      # (rid, request)
        slots: List[Optional[Request]] = [None] * B
        admitting: List[Optional[_Admission]] = [None] * B
        active = np.zeros(B, bool)
        staged = np.zeros(B, np.int64)      # host mirror of local_len
        slot_steps = np.zeros(B, np.int64)  # watchdog: decode steps per slot
        admit_t = np.zeros(B, float)
        prev: Optional[_Readback] = None    # step t's ids (copy in flight)
        prev_snapshot: List[Optional[Request]] = [None] * B
        last_deliver_t: Optional[float] = None
        last_deliver: set = set()
        metrics = ServeMetrics(n_slots=B)
        c = _Call(queue, slots, admitting, active, state, store, plan,
                  max_ctx, metrics)
        t_start = time.perf_counter()

        def finish(i: int, req: Request, status: str = "ok"):
            req.done = True
            req.status = status
            dt = time.perf_counter() - admit_t[i]
            n_decode = len(req.out_tokens) - 1   # first token is prefill's
            req.decode_tps = n_decode / dt if dt > 0 and n_decode > 0 else 0.0
            slots[i] = None
            active[i] = False

        # Spans (``repro_torch.spans``) cover the whole scheduler iteration:
        # admit (per request: prefill / chunk + fin, graft, admit_slot),
        # first_token, decode, harvest and flush.
        while queue or active.any() or any(a is not None for a in admitting) \
                or prev is not None:
            # ---- admission: one prefill (chunk) per admitting slot ---------
            t0 = time.perf_counter()
            completed = [(i, a) for i in range(B)
                         if (a := admit(c, i)) is not None]
            if completed:
                with spans.host("first_token", requests=len(completed)):
                    # coalesced first-token sampling: ONE host sync for
                    # every request admitted this iteration
                    stacked = torch.cat([a.logits for _, a in completed], 0)
                    first = sample(stacked)
                    first = first.cpu().numpy()  # retrolint: sync(coalesced first tokens)
                    spans.resolve()     # the admissions' device spans
                    now = time.perf_counter()
                    upd = np.zeros(B, np.int32)
                    mask = np.zeros(B, bool)
                    for (i, adm), tok in zip(completed, first):
                        req = adm.req
                        req.ttft_s = now - t_start
                        req.out_tokens.append(int(tok))
                        metrics.tokens_out += 1
                        metrics.ttft_s.append(req.ttft_s)
                        admit_t[i] = now
                        slots[i] = req
                        req.slot = i
                        active[i] = True
                        slot_steps[i] = 0
                        upd[i], mask[i] = tok, True
                        # device local_len after admission: both admissions
                        # give ``local`` (``_bucket`` pads only prompts of
                        # at least sink + local tokens)
                        staged[i] = min(cfg.retro.local,
                                        max(adm.consumed - cfg.retro.sink, 0))
                        if len(req.out_tokens) >= req.max_new_tokens:
                            finish(i, req)
                    merge_tokens(tokens_dev, to_device(upd, dev),
                                 to_device(mask, dev))
            metrics.prefill_s += time.perf_counter() - t0

            # ---- one decode step over the whole slot batch -----------------
            # Enqueue step t+1 before harvesting step t's ids.
            t0 = time.perf_counter()
            cur = None
            if active.any():
                with spans.host("decode", step=metrics.steps):
                    # the ids (a static output; the step also writes them
                    # into tokens_dev) are copied to the host on this stream
                    # after this step and before the next one overwrites
                    # them: stream order keeps it safe
                    _, new_sampled = store.decode_step(c.state, tokens_dev,
                                                       active)
                    cur = _Readback(new_sampled, h_ids[metrics.steps % 2])
                    snapshot = [slots[i] if active[i] else None
                                for i in range(B)]
                    metrics.steps += 1
                    metrics.occupied_slot_steps += int(active.sum())
                    staged[active] += 1
                    slot_steps[active] += 1
                    # unrecoverable link fault: finish only the affected
                    # requests (their in-flight token is dropped by the
                    # lagged harvest)
                    for i in sorted(store.failed_slots):
                        if slots[i] is not None:
                            finish(i, slots[i], status="error")
                    store.failed_slots.clear()
                    if self.max_decode_steps is not None:
                        for i in range(B):
                            if active[i] and \
                                    slot_steps[i] >= self.max_decode_steps:
                                finish(i, slots[i], status="timeout")

            # ---- harvest step t's ids (one step lagged) --------------------
            if prev is not None:
                with spans.host("harvest"):
                    ids = prev.get()            # the decode loop's only sync
                    now = time.perf_counter()
                    delivered = set()
                    for i, req in enumerate(prev_snapshot):
                        if req is None or slots[i] is not req or req.done:
                            continue    # freed/re-admitted: speculative token
                        delivered.add(id(req))
                        req.out_tokens.append(int(ids[i]))
                        metrics.tokens_out += 1
                        if len(req.out_tokens) >= req.max_new_tokens:
                            finish(i, req)
                    if delivered:
                        if last_deliver_t is not None \
                                and (delivered & last_deliver):
                            metrics.step_s.append(now - last_deliver_t)
                        last_deliver_t, last_deliver = now, delivered
            if cur is not None:
                prev, prev_snapshot = cur, snapshot
            else:
                prev, prev_snapshot = None, [None] * B
            metrics.decode_s += time.perf_counter() - t0

            # ---- per-row masked index update (off the per-step hot path) ---
            if use_flush and (staged >= lbuf).any():
                rows = staged >= lbuf
                with spans.host("flush", rows=int(rows.sum())):
                    c.state = store.flush(c.state, rows)
                metrics.flushes += 1
                staged[rows] -= cfg.retro.update_segment
        store.export_stats(metrics)
        # inspection hooks (tests, smoke)
        self.last_graph, self.last_plane = store.kept()
        self.last_state = c.state
        return metrics

    def run_wave(self, requests: List[Request],
                 extra_batch: Optional[Dict] = None,
                 seed: int = 0) -> ServeMetrics:
        """Serve one batch of requests with one slot each; ``extra_batch``
        (e.g. vlm ``patch_embeds`` (B, P, D)) is split into the requests'
        ``extra`` rows."""
        if extra_batch:
            for i, r in enumerate(requests):
                r.extra = {k: v[i:i + 1] for k, v in extra_batch.items()}
        return self.serve(requests, batch_size=len(requests), seed=seed)
