"""Continuous-batching serving engine with chunked admission and a decode
loop that reads ids back once per step, one step late.

Port of ``repro/serving/engine.py`` (retro runtime, direct store, chunked
admission, every decode-attention impl; blocking admission,
``runtime="full"``, the host-offload plane and ``run_wave`` are not ported
yet).

The decode loop runs a fixed number of slots. A request's prompt is consumed
one fixed-size chunk per scheduler iteration, interleaved between decode
steps; when its last chunk is in, the finalized single-slot wave state is
grafted into the batch state. First tokens of all requests admitted in the
same iteration are sampled on device and read back with one coalesced copy.
Decode sampling stays on device: step t's ids are copied to pinned host
memory behind an event and harvested after step t+1 has been enqueued, so
completion is detected one step late (the speculative extra token of a
finished request is dropped). Staging-buffer flushes are per-row masked.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import resolve_attn_impl
from repro_torch.core.wave_index import local_buffer_size
from repro_torch.core.zones import plan_zones
from repro_torch.models import model as M


@dataclass
class Request:
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    # ---- filled by the engine ----
    ttft_s: float = 0.0                 # enqueue -> first token
    decode_tps: float = 0.0             # this request's decode tokens/s
    status: str = "ok"                  # "ok" | "timeout"
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
    request_tps: List[float] = field(default_factory=list)
    # gaps between consecutive token deliveries of continuing requests
    step_s: List[float] = field(default_factory=list)

    @property
    def decode_tps(self) -> float:
        return self.tokens_out / max(self.decode_s, 1e-9)

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

    @property
    def ttft_p50_s(self) -> float:
        return float(np.percentile(self.ttft_s, 50)) if self.ttft_s else 0.0

    @property
    def ttft_p99_s(self) -> float:
        return float(np.percentile(self.ttft_s, 99)) if self.ttft_s else 0.0


@dataclass
class _Admission:
    """One slot's in-progress chunked admission."""
    req: Request
    cstate: Any = None                  # PrefillChunkState
    consumed: int = 0
    logits: Any = None                  # device logits of the last chunk


class _Readback:
    """Device (B,) ids copied to host without blocking; ``get`` waits for
    that copy only (not for work enqueued after it)."""

    def __init__(self, ids: torch.Tensor):
        if ids.device.type == "cuda":
            self.host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            self.host.copy_(ids, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = ids.clone(), None

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor without blocking the host: a pageable
    copy would wait for all work queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()            # never alias the caller's host array


def graft(big, small, slot: int):
    """Copy the single-row serve state ``small`` into row ``slot`` of the
    batch state ``big``, in place (the reference donates ``big``)."""
    for bst, sst in zip(big.kv, small.kv):
        for b, s in zip(bst, sst):
            b[slot:slot + 1].copy_(s)
    return big


class ServeEngine:
    """``serve(requests, batch_size)`` — continuous scheduler over a slot
    batch. ``max_context`` pins the decode geometry (zone plan, cluster-store
    capacity); a request's outputs do not depend on what shares the batch.
    ``attn_impl`` selects the decode-attention implementation ("jnp"
    reference, "fused" paged kernel, "pallas" gathered-buffer kernel); None
    defers to ``cfg.retro.attn_impl``. ``device`` defaults to ``cuda`` and
    raises when there is no card."""

    def __init__(self, cfg: ModelConfig, params, *, gen_headroom: int = 1024,
                 max_context: Optional[int] = None,
                 prefill_chunk: int = 256, attn_impl: Optional[str] = None,
                 max_decode_steps: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        M._dense_only(cfg)
        self.attn_impl = resolve_attn_impl(attn_impl or cfg.retro.attn_impl)
        self.cfg = cfg
        self.params = params
        self.gen_headroom = gen_headroom
        self.max_context = max_context
        self.prefill_chunk = max(1, prefill_chunk)
        self.max_decode_steps = max_decode_steps

    @staticmethod
    def _sample_dev(logits) -> torch.Tensor:
        """Greedy sampling on device: (B, V) logits -> (B,) int32 ids, no
        host transfer."""
        return logits.argmax(dim=-1).to(torch.int32)

    @torch.inference_mode()
    def serve(self, requests: List[Request],
              batch_size: int) -> ServeMetrics:
        """Serve a FIFO queue through ``batch_size`` continuous slots."""
        cfg, dev = self.cfg, self.device
        if not requests:
            raise ValueError("no requests")
        max_ctx = self.max_context or max(len(r.prompt) for r in requests)
        min_len = cfg.retro.sink + 1
        for r in requests:
            if not min_len <= len(r.prompt) <= max_ctx:
                raise ValueError(f"prompt length {len(r.prompt)} outside "
                                 f"[{min_len}, {max_ctx}]")
        B = batch_size
        plan = plan_zones(max_ctx, cfg.retro, self.gen_headroom)
        state = M.make_serve_state(cfg, B, max_ctx,
                                   gen_headroom=self.gen_headroom, device=dev)
        lbuf = local_buffer_size(cfg.retro)

        queue = deque(requests)
        slots: List[Optional[Request]] = [None] * B
        admitting: List[Optional[_Admission]] = [None] * B
        active = np.zeros(B, bool)
        staged = np.zeros(B, np.int64)      # host mirror of local_len
        slot_steps = np.zeros(B, np.int64)  # watchdog: decode steps per slot
        admit_t = np.zeros(B, float)
        tokens_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        prev: Optional[_Readback] = None    # step t's ids (copy in flight)
        prev_snapshot: List[Optional[Request]] = [None] * B
        last_deliver_t: Optional[float] = None
        last_deliver: set = set()
        metrics = ServeMetrics(n_slots=B)
        t_start = time.perf_counter()

        def finish(i: int, req: Request, status: str = "ok"):
            req.done = True
            req.status = status
            dt = time.perf_counter() - admit_t[i]
            n_decode = len(req.out_tokens) - 1   # first token is prefill's
            req.decode_tps = n_decode / dt if dt > 0 and n_decode > 0 else 0.0
            if n_decode > 0:
                metrics.request_tps.append(req.decode_tps)
            slots[i] = None
            active[i] = False

        while queue or active.any() or any(a is not None for a in admitting) \
                or prev is not None:
            # ---- admission: one prefill chunk per admitting slot ----------
            t0 = time.perf_counter()
            completed: List[Tuple[int, _Admission]] = []
            for i in range(B):
                if admitting[i] is None and not active[i] \
                        and slots[i] is None and queue:
                    admitting[i] = _Admission(
                        req=queue.popleft(),
                        cstate=M.make_prefill_chunk_state(
                            cfg, 1, max_ctx, chunk=self.prefill_chunk,
                            gen_headroom=self.gen_headroom, device=dev))
                adm = admitting[i]
                if adm is None:
                    continue
                L, C = len(adm.req.prompt), self.prefill_chunk
                n = min(C, L - adm.consumed)
                toks = np.zeros((1, C), np.int32)
                toks[0, :n] = adm.req.prompt[adm.consumed:adm.consumed + n]
                adm.logits, adm.cstate = M.apply_prefill_chunk(
                    self.params, cfg, {"tokens": to_device(toks, dev)},
                    adm.cstate,
                    chunk_lens=to_device(np.array([n], np.int32), dev))
                adm.consumed += n
                metrics.prefill_tokens += n
                if adm.consumed >= L:
                    st1 = M.finalize_prefill_chunk(cfg, adm.cstate, total_len=L)
                    state = graft(state, st1, i)
                    adm.cstate = None
                    admitting[i] = None
                    completed.append((i, adm))

            if completed:
                # coalesced first-token sampling: ONE host sync for every
                # request admitted this iteration
                stacked = torch.cat([a.logits for _, a in completed], 0)
                first = self._sample_dev(stacked).cpu().numpy()
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
                    staged[i] = min(cfg.retro.local,
                                    max(adm.consumed - cfg.retro.sink, 0))
                    if len(req.out_tokens) >= req.max_new_tokens:
                        finish(i, req)
                tokens_dev = torch.where(to_device(mask, dev),
                                         to_device(upd, dev), tokens_dev)
            metrics.prefill_s += time.perf_counter() - t0

            # ---- one decode step over the whole slot batch -----------------
            # Enqueue step t+1 before harvesting step t's ids.
            t0 = time.perf_counter()
            cur = None
            if active.any():
                logits, state = M.apply_decode(
                    self.params, cfg, state, tokens_dev, plan=plan,
                    active=to_device(active, dev), attn_impl=self.attn_impl)
                new_sampled = self._sample_dev(logits)   # device, no sync
                cur = _Readback(new_sampled)
                snapshot = [slots[i] if active[i] else None for i in range(B)]
                metrics.steps += 1
                metrics.occupied_slot_steps += int(active.sum())
                staged[active] += 1
                slot_steps[active] += 1
                if self.max_decode_steps is not None:
                    for i in range(B):
                        if active[i] and slot_steps[i] >= self.max_decode_steps:
                            finish(i, slots[i], status="timeout")

            # ---- harvest step t's ids (one step lagged) --------------------
            if prev is not None:
                ids = prev.get()            # the decode loop's only sync
                now = time.perf_counter()
                delivered = set()
                for i, req in enumerate(prev_snapshot):
                    if req is None or slots[i] is not req or req.done:
                        continue        # freed/re-admitted: speculative token
                    delivered.add(id(req))
                    req.out_tokens.append(int(ids[i]))
                    metrics.tokens_out += 1
                    if len(req.out_tokens) >= req.max_new_tokens:
                        finish(i, req)
                if delivered:
                    if last_deliver_t is not None and (delivered & last_deliver):
                        metrics.step_s.append(now - last_deliver_t)
                    last_deliver_t, last_deliver = now, delivered
            if cur is not None:
                prev, prev_snapshot = cur, snapshot
                tokens_dev = new_sampled
            else:
                prev, prev_snapshot = None, [None] * B
            metrics.decode_s += time.perf_counter() - t0

            # ---- per-row masked index update (off the per-step hot path) ---
            if (staged >= lbuf).any():
                rows = staged >= lbuf
                state = M.flush_state(cfg, state)
                metrics.flushes += 1
                staged[rows] -= cfg.retro.update_segment
        self.last_state = state             # inspection hook (tests, smoke)
        return metrics
