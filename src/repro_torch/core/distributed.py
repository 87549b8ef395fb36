"""Sharded retrieval on ``torch.distributed``. Port of
``repro/core/distributed.py`` (the reference runs it under ``shard_map``).

The cluster axis of a layer's wave state is split over the ranks of a
process group: rank ``i`` holds clusters ``[i * m_loc, (i + 1) * m_loc)``
(``shard_state``) and the steady zone and counters whole. Every rank ranks
only its own clusters, retrieves its local top ``ceil(r / n)`` (and
estimates its local ``ceil(e / n)``), and computes an unnormalised merge
``(num, den, m)``; rank 0 alone adds the steady zone. The ranks then
combine with one ``all_reduce(MAX)`` of ``m`` and one ``all_reduce(SUM)``
of ``[num | den]`` rescaled to the global max: B * Hq * (hd + 2) floats a
layer, whatever r and the cluster capacity.

The union of the ranks' local top sets is not the global top r; the
estimation zone covers the stragglers (``tests/test_torch_distributed.py``
measures both against full attention).

The backend is the caller's choice: gloo on the CPU or for ranks that
share one card (gloo reduces CUDA tensors through the host itself, MAX
included: checked on the H100 machine with torch 2.11), NCCL where every
rank has its own card.
``collective_tally`` records each reduction's kind and bytes for the
dry-run tools; ``run_ranks`` starts n ranks of a function with a deadline.
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import RetroConfig
from repro_torch.core.attention import wave_attention_decode
from repro_torch.core.wave_index import WaveState
from repro_torch.core.zones import ZonePlan
from repro_torch.launch.mesh import PartitionSpec as P

# the WaveState fields with a cluster axis (dim 2: (B, H, M, ...))
CLUSTER_FIELDS = ("k_store", "v_store", "pos_store", "centroid", "vsum",
                  "size", "stored", "max_pos")


def local_plan(plan: ZonePlan, n_shards: int) -> ZonePlan:
    return plan._replace(r=max(1, math.ceil(plan.r / n_shards)),
                         e=max(1, math.ceil(plan.e / n_shards)))


def shard_state(state: WaveState, rank: int, n: int) -> WaveState:
    """Rank ``rank``'s block of the cluster axis (views: nothing is
    copied); the other fields whole. M must divide by ``n``."""
    M = state.centroid.shape[2]
    if M % n:
        raise ValueError(f"{M} clusters do not split over {n} ranks")
    m_loc = M // n
    return state._replace(**{
        f: getattr(state, f)[:, :, rank * m_loc:(rank + 1) * m_loc]
        for f in CLUSTER_FIELDS})


def state_specs_cluster_sharded(state: WaveState, axis: str = "model"):
    """Partition specs of a per-layer WaveState with the cluster axis on
    ``axis`` (per-layer leaves: (B, H, M, ...))."""
    def spec(name, leaf):
        s = [None] * leaf.ndim
        if name in CLUSTER_FIELDS:
            s[2] = axis
        return P(*s)

    return WaveState(*[spec(f, getattr(state, f)) for f in WaveState._fields])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_TALLIES: List[list] = []


@contextlib.contextmanager
def collective_tally():
    """Record every collective of this module while open: yields a list
    that gets one ``(kind, bytes)`` per call (the reduced tensor's bytes)."""
    rec: list = []
    _TALLIES.append(rec)
    try:
        yield rec
    finally:
        _TALLIES.remove(rec)


def all_reduce(t: torch.Tensor, op, group=None) -> torch.Tensor:
    """In-place all-reduce of ``t``, tallied."""
    for rec in _TALLIES:
        rec.append(("all-reduce", t.numel() * t.element_size()))
    dist.all_reduce(t, op=op, group=group)
    return t


def shard_plan(plan: ZonePlan, n_shards: int, m_loc: int) -> ZonePlan:
    """A rank's plan: ``local_plan`` clamped to its ``m_loc`` clusters
    (full coverage: r = every local cluster, e = 0)."""
    lp = local_plan(plan, n_shards)
    r_loc = min(lp.r, m_loc)
    return lp._replace(r=r_loc, e=min(lp.e, m_loc - r_loc))


def shard_wave_attention(q, state: WaveState, retro: RetroConfig,
                         plan: ZonePlan, *, rank: int, n_shards: int,
                         window=None, softcap=None):
    """One rank's partial merge over its own clusters (``state`` holds its
    block, ``shard_state``; ``shard_plan``): -> (num (B,Hkv,G,hd), den,
    m (B,Hkv,G)) f32, num and den scaled by exp(-m)."""
    m_loc = state.centroid.shape[2]
    lp = shard_plan(plan, n_shards, m_loc)
    num, den, m, _ = wave_attention_decode(
        q, state, retro, lp, window=window, softcap=softcap,
        cluster_offset=rank * m_loc, include_steady=rank == 0,
        return_parts=True)
    return num, den, m


def merge_parts(num, den, m, group=None) -> torch.Tensor:
    """Combine the ranks' partial merges: the global max, each rank's parts
    rescaled to it and summed (one reduction of ``[num | den]``), then
    normalised. -> (B, Hkv, G, hd) f32, the same on every rank."""
    m_glob = all_reduce(m.clone(), dist.ReduceOp.MAX, group)
    scale = torch.exp(m - m_glob)
    parts = torch.cat([num * scale[..., None], (den * scale)[..., None]], -1)
    all_reduce(parts, dist.ReduceOp.SUM, group)
    return parts[..., :-1] / torch.clamp(parts[..., -1:], min=1e-30)


def distributed_wave_attention(q, state: WaveState, retro: RetroConfig,
                               plan: ZonePlan, group=None, *, window=None,
                               softcap=None):
    """Tripartite decode attention with the cluster axis sharded over
    ``group`` (default: the default group). q: (B, Hq, hd), the same on
    every rank; ``state``: this rank's block (``shard_state``). Returns
    (B, Hq, hd) in q's dtype, the same on every rank."""
    B, Hq, hd = q.shape
    num, den, m = shard_wave_attention(
        q, state, retro, plan, rank=dist.get_rank(group),
        n_shards=dist.get_world_size(group), window=window, softcap=softcap)
    return merge_parts(num, den, m, group).reshape(B, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# n ranks of a function, with a deadline
# ---------------------------------------------------------------------------

def _rank_entry(rank, n, backend, init_method, timeout, fn, args, results):
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 — the rank's failure goes to run_ranks
        results.put((rank, traceback.format_exc(), None))


def run_ranks(fn: Callable, n: int, args: Sequence[Any] = (), *,
              backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(rank, n, *args)`` in ``n`` spawned processes joined in one
    process group (``backend``, a ``file://`` rendezvous in a temporary
    directory) and return the n results in rank order. ``fn`` must be
    importable by name; ``args`` travel to the ranks by
    ``torch.multiprocessing`` (CUDA tensors by IPC, not copied), results
    back by value. A rank that raises, or exits without a result, raises
    here; if the ranks have not all returned ``timeout`` seconds after the
    start, every rank is killed and ``TimeoutError`` is raised."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, n, backend, init, timeout, fn, tuple(args),
                               results))
             for r in range(n)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        dead = set()
        while len(out) < n:
            left = deadline - time.monotonic()
            try:
                rank, err, payload = results.get(timeout=min(max(left, 0.0),
                                                             1.0))
            except queue.Empty:
                missing = sorted(set(range(n)) - set(out))
                if left <= 0:
                    raise TimeoutError(f"ranks {missing} of {n} did not "
                                       f"return within {timeout} s") from None
                gone = [r for r in missing if procs[r].exitcode is not None]
                if set(gone) & dead:     # exited, and a second wait was empty
                    raise RuntimeError(
                        f"ranks {gone} of {n} exited without a result (exit "
                        f"codes {[procs[r].exitcode for r in gone]})") \
                        from None
                dead |= set(gone)
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            out[rank] = pickle.loads(payload)
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=5 if len(out) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
