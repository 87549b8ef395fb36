"""Wave buffer: the accuracy-agnostic buffer manager (paper Sec. 4.3).

Port of ``repro/core/wave_buffer.py``, the port's own copy (pure numpy, no
JAX). This is the paper's CPU control plane of the host-offload
configuration: KV blocks in host memory, a fixed-size device block cache,
an execution buffer assembled from {steady zone, cache hits, misses}.

* cluster -> block indirection via a mapping table (logical clusters may span
  multiple fixed-size physical blocks),
* synchronous cache *access* on the critical path, asynchronous (deferred,
  vectorized) cache *update*: LRU metadata is maintained off the hot path,
* hit/miss/transfer accounting (Fig. 16-style analyses).

The serve engine (``serving/engine.py``, ``_OffloadPlane``) mirrors each
buffer's ``cache`` into a per-layer device block cache and stages misses on
the card; this module never touches a device.

The host store keeps the reference's packed f32 row layout ``[K | V | pos]``,
so checksums, byte counters and the fault schedule (``FaultyTransport``
draws a corruption offset over the row's element count) equal the
reference's bit for bit.

Fault model
-----------
The miss-fetch path goes through a pluggable :class:`LinkTransport`. The
production transport is an infallible zero-copy read of the host store; the
seed-deterministic :class:`FaultyTransport` injects scheduled transient fetch
failures, latency spikes, and payload corruption for chaos testing:

* **Checksums**: one ``zlib.crc32`` per packed payload row, computed when
  the row is stored (buffer construction and :meth:`store_rows`, which the
  serve engine's segment flush uses) and verified on every transport fetch.
  A mismatch counts as ``corrupt_fetches`` and is retried.
* **Bounded retry + exponential backoff**: a failed attempt costs
  ``backoff_s * 2**attempt`` on a *virtual* clock (no real sleeps); at most
  ``max_retries`` retries per miss.
* **Deadline**: ``translate`` takes an optional virtual time budget shared
  by all misses of the call. A miss whose retries or budget run out FAILS
  for this step: it is reported via the ``ok`` mask, stays out of the
  pending set, and is refetched in a later update window. The caller masks
  the cluster out of the retrieval zone and covers its attention mass with
  the estimation zone.
* **Unrecoverable faults**: :class:`FatalTransportError` propagates to the
  caller (the serve engine finishes the affected request with
  ``status="error"``; other slots keep serving).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def _crc(row: np.ndarray) -> int:
    """crc32 of a payload row's bytes (read in place when contiguous)."""
    return zlib.crc32(np.ascontiguousarray(row))


class TransientFault(RuntimeError):
    """A fetch attempt failed recoverably (retry may succeed)."""


class FatalTransportError(RuntimeError):
    """The link is unrecoverably broken for this fetch (no retry)."""


@dataclass
class FaultProfile:
    """Seed-deterministic fault schedule for :class:`FaultyTransport`.

    Rates are per-attempt probabilities; ``seed`` fixes the schedule. The
    virtual latencies (``latency_s``, ``spike_s``) are charged against the
    translate call's deadline budget — never slept.
    """
    transient: float = 0.0      # P(attempt raises TransientFault)
    corrupt: float = 0.0        # P(payload corrupted in flight — crc catches)
    spike: float = 0.0          # P(latency spike on a successful attempt)
    fatal: float = 0.0          # P(attempt raises FatalTransportError)
    latency_s: float = 0.0      # base virtual latency per successful fetch
    spike_s: float = 0.05       # extra virtual latency of a spike
    seed: int = 0

    @classmethod
    def parse(cls, spec: str) -> "FaultProfile":
        """Parse ``"transient=0.2,corrupt=0.01,seed=3"``-style CLI specs."""
        kw: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            if key not in cls.__dataclass_fields__:
                raise ValueError(
                    f"unknown fault-profile field {key!r} (known: "
                    f"{', '.join(cls.__dataclass_fields__)})")
            kw[key] = int(val) if key == "seed" else float(val)
        return cls(**kw)


class LinkTransport:
    """Pluggable host->device link for the miss-fetch path.

    ``fetch(store, cid)`` returns ``(payload_row, virtual_latency_s)``. The
    production transport is an infallible zero-copy view of the host store
    with zero virtual latency — byte-identical to the pre-transport code.
    """

    def fetch(self, store: np.ndarray, cid: int
              ) -> Tuple[np.ndarray, float]:
        return store[cid], 0.0


class FaultyTransport(LinkTransport):
    """Seed-deterministic fault injection over the link.

    Corruption happens on a COPY of the payload row (the host store is never
    damaged — this models a bit flip in flight, which the per-row crc32
    catches on arrival).
    """

    def __init__(self, profile: FaultProfile):
        self.profile = profile
        self.rng = np.random.default_rng(profile.seed)

    def fetch(self, store: np.ndarray, cid: int
              ) -> Tuple[np.ndarray, float]:
        p = self.profile
        if p.fatal and self.rng.random() < p.fatal:
            raise FatalTransportError(
                f"unrecoverable link failure fetching cluster {cid}")
        if p.transient and self.rng.random() < p.transient:
            raise TransientFault(f"transient fetch failure, cluster {cid}")
        lat = p.latency_s
        if p.spike and self.rng.random() < p.spike:
            lat += p.spike_s
        payload = store[cid]
        if p.corrupt and self.rng.random() < p.corrupt:
            payload = payload.copy()
            flat = payload.reshape(-1)
            flat[int(self.rng.integers(flat.size))] += 1.0
        return payload, lat


@dataclass
class BufferStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    bytes_from_cache: int = 0
    bytes_over_link: int = 0        # host->device traffic (the "PCIe" analogue)
    bytes_from_pending: int = 0     # repeat-miss bytes served from the pending set
    bytes_steady: int = 0
    updates_deferred: int = 0
    pending_hits: int = 0           # repeat misses served from the pending set
    faults: int = 0                 # transient fetch failures observed
    retries: int = 0                # retry attempts issued (with backoff)
    corrupt_fetches: int = 0        # crc32 mismatches caught on fetch
    failed_fetches: int = 0         # misses abandoned (retries/deadline out)

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(1, self.lookups)

    @property
    def effective_hit_ratio(self) -> float:
        """Fig. 16-style effective hit rate: a pending hit never crosses the
        link again, so for traffic purposes it IS a hit — counting it as a
        plain miss (as ``hit_ratio`` alone would) understates the cache under
        repeat misses within one update window."""
        return (self.hits + self.pending_hits) / max(1, self.lookups)

    def merge(self, other: "BufferStats") -> None:
        """Accumulate another buffer's counters (engine-level aggregation)."""
        for f in ("lookups", "hits", "misses", "bytes_from_cache",
                  "bytes_over_link", "bytes_from_pending", "bytes_steady",
                  "updates_deferred", "pending_hits", "faults", "retries",
                  "corrupt_fetches", "failed_fetches"):
            setattr(self, f, getattr(self, f) + getattr(other, f))


class ClusterMappingTable:
    """Logical cluster -> physical block address translation (paper Fig. 9).

    Each cluster occupies ``blocks_per_cluster`` consecutive physical blocks in
    host memory; the table tracks, per cluster, the device-cache slot (or -1).
    Implemented as flat int arrays for O(1) vectorized lookup.
    """

    def __init__(self, n_clusters: int, blocks_per_cluster: int):
        self.blocks_per_cluster = blocks_per_cluster
        self.host_block = np.arange(n_clusters, dtype=np.int64) * blocks_per_cluster
        self.cache_slot = np.full(n_clusters, -1, dtype=np.int64)

    def lookup(self, cluster_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (cache_slot per cluster (-1 = miss), host_block per cluster)."""
        return self.cache_slot[cluster_ids], self.host_block[cluster_ids]


class WaveBuffer:
    """Device block cache + execution-buffer assembly with deferred LRU.

    ``kv_host``: (n_clusters, bytes_per_cluster) conceptual host store — here
    an ndarray of cluster payloads (keys+values flattened). The device cache
    holds ``cache_clusters`` payload rows.
    """

    def __init__(self, kv_host: np.ndarray, cache_clusters: int,
                 blocks_per_cluster: int = 1, policy: str = "lru",
                 transport: Optional[LinkTransport] = None,
                 max_retries: int = 2, backoff_s: float = 1e-3):
        assert policy in ("lru", "fifo", "clock")
        if cache_clusters < 0:
            raise ValueError(f"cache_clusters must be >= 0, got {cache_clusters}")
        # cache_clusters == 0 (tiny int(frac * n) configs round to zero) is an
        # explicit PASS-THROUGH: every lookup is a miss served over the link
        # (with pending-set dedup within an update window) and nothing is ever
        # admitted — not an accident of the _admit early-return path.
        self.passthrough = cache_clusters == 0
        self.kv_host = kv_host
        n = kv_host.shape[0]
        self.table = ClusterMappingTable(n, blocks_per_cluster)
        self.cache = np.zeros((cache_clusters,) + kv_host.shape[1:],
                              dtype=kv_host.dtype)
        self.cache_owner = np.full(cache_clusters, -1, dtype=np.int64)
        self.policy = policy
        self.clock_hand = 0
        self.ref_bit = np.zeros(cache_clusters, dtype=bool)
        self.stamp = np.zeros(cache_clusters, dtype=np.int64)   # LRU timestamps
        self.tick = 0
        self.stats = BufferStats()
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pending_map: Dict[int, np.ndarray] = {}   # id -> fetched payload
        self.bytes_per_cluster = int(kv_host[0].nbytes) if n else 0
        self.transport = transport if transport is not None else LinkTransport()
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.checksums = np.array(
            [_crc(kv_host[i]) for i in range(n)],
            dtype=np.uint64)

    # ------------------------------------------------------------------- store
    def store_rows(self, start: int, rows: np.ndarray) -> None:
        """Write packed payload rows ``[start, start+len)`` into the host
        store and refresh their checksums (the serve engine's segment flush
        MUST come through here — a raw ``kv_host[...] = ...`` slice write
        would leave stale crcs and every later fetch of those clusters would
        count as corrupt)."""
        self.kv_host[start:start + len(rows)] = rows
        for i in range(start, start + len(rows)):
            self.checksums[i] = _crc(self.kv_host[i])

    # ------------------------------------------------------------------- fetch
    def _fetch(self, cid: int, budget: Optional[float]
               ) -> Tuple[Optional[np.ndarray], float]:
        """One miss fetch through the transport, with crc verification,
        bounded retry + exponential virtual backoff, and a virtual deadline
        budget. Returns ``(payload_or_None, virtual_seconds_spent)``.
        ``FatalTransportError`` propagates (the caller fails the request)."""
        spent = 0.0
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.stats.retries += 1
                spent += self.backoff_s * (2 ** (attempt - 1))
            if budget is not None and spent > budget:
                return None, spent              # overdue before issuing
            try:
                payload, lat = self.transport.fetch(self.kv_host, cid)
            except TransientFault:
                self.stats.faults += 1
                continue
            spent += lat
            if budget is not None and spent > budget:
                return None, spent              # arrived past the deadline
            if _crc(payload) != int(self.checksums[cid]):
                self.stats.corrupt_fetches += 1
                continue
            return payload, spent
        return None, spent

    # ------------------------------------------------------------------ access
    def translate(self, cluster_ids: np.ndarray, deadline_s: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Control-plane access for one decode step (synchronous).

        Returns ``(slot, hit, miss_payload, ok)``: per-id device-cache slot
        (>= 0 for hits, -1 for misses), the hit mask, the host payload of
        every MISS row (hit rows are zero — the serve engine reads hits from
        the device cache store and only ships misses over the link), and the
        per-id fetch-success mask. ``ok`` is False for a miss whose fetch
        exhausted its retries or the ``deadline_s`` virtual budget (shared
        across all misses of this call); such a miss stays OUT of the pending
        set — its payload row is zero, the caller must mask the cluster out
        of this step's attend, and a later window refetches it. Records
        hit/miss/pending traffic; cache *insertion* stays deferred.
        """
        cluster_ids = np.asarray(cluster_ids, dtype=np.int64)
        n = self.kv_host.shape[0]
        if len(cluster_ids):
            bad = (cluster_ids < 0) | (cluster_ids >= n)
            if bad.any():
                raise ValueError(
                    f"cluster_ids out of range for a store of {n} clusters: "
                    f"{np.unique(cluster_ids[bad])[:8].tolist()}")
        slot, _ = self.table.lookup(cluster_ids)
        hit = slot >= 0
        self.tick += 1
        self.stats.lookups += len(cluster_ids)
        self.stats.hits += int(hit.sum())
        self.stats.misses += int((~hit).sum())
        self.stats.bytes_from_cache += int(hit.sum()) * self.bytes_per_cluster
        if hit.any():
            self.stamp[slot[hit]] = self.tick            # touch (cheap, vector)
            self.ref_bit[slot[hit]] = True

        miss_payload = np.zeros((len(cluster_ids),) + self.kv_host.shape[1:],
                                dtype=self.kv_host.dtype)
        ok = np.ones(len(cluster_ids), dtype=bool)
        # A cluster missed again before the deferred update lands is served
        # from the pending set: one link transfer per cluster per update
        # window, not one per lookup (previously double-fetched AND
        # double-counted in bytes_over_link).
        if (~hit).any():
            fresh_ids: List[int] = []
            elapsed = 0.0                       # virtual clock, per call
            for pos in np.where(~hit)[0]:
                cid = int(cluster_ids[pos])
                block = self._pending_map.get(cid)
                if block is None:
                    budget = None if deadline_s is None else deadline_s - elapsed
                    block, spent = self._fetch(cid, budget)
                    elapsed += spent
                    if block is None:           # failed: stays out of the
                        ok[pos] = False         # pending set -> refetched in
                        self.stats.failed_fetches += 1   # a later window
                        continue
                    self._pending_map[cid] = block
                    fresh_ids.append(cid)
                    self.stats.bytes_over_link += self.bytes_per_cluster
                else:
                    self.stats.pending_hits += 1
                    self.stats.bytes_from_pending += self.bytes_per_cluster
                miss_payload[pos] = block
            # defer admission of fresh misses (paper: async update by CPU pool)
            if fresh_ids and not self.passthrough:
                self._pending.append((
                    np.asarray(fresh_ids, dtype=np.int64),
                    np.stack([self._pending_map[c] for c in fresh_ids])))
                self.stats.updates_deferred += 1
        return slot, hit, miss_payload, ok

    def assemble(self, cluster_ids: np.ndarray,
                 steady_payload: Optional[np.ndarray] = None) -> np.ndarray:
        """Assemble the execution buffer for one decode step (synchronous).

        Returns the concatenated payloads [steady | retrieved clusters] and
        records hit/miss traffic. Cache *insertion* is deferred (async update).
        """
        slot, hit, payload, _ = self.translate(cluster_ids)
        if hit.any():
            payload[hit] = self.cache[slot[hit]]
        if steady_payload is not None:
            self.stats.bytes_steady += int(steady_payload.nbytes)
            return np.concatenate([steady_payload, payload], axis=0)
        return payload

    # ------------------------------------------------------------------ update
    def apply_updates(self) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Apply deferred admissions (runs off the critical path).

        Returns the applied admissions as ``(slots, cluster_ids, payload)``
        triples so a caller that mirrors this cache in device memory (the
        serve engine's block-cache store) can replay the same scatter.
        """
        admissions: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for ids, payload in self._pending:
            adm = self._admit(ids, payload)
            if adm is not None:
                admissions.append(adm)
        self._pending.clear()
        self._pending_map.clear()
        return admissions

    def _victims(self, n: int) -> np.ndarray:
        if self.policy == "lru":
            return np.argsort(self.stamp)[:n]
        if self.policy == "fifo":
            v = (self.clock_hand + np.arange(n)) % len(self.cache_owner)
            self.clock_hand = int((self.clock_hand + n) % len(self.cache_owner))
            return v
        # clock (second chance) — victims must be unique within a batch
        victims: list = []
        chosen = set()
        guard = 0
        size = len(self.cache_owner)
        while len(victims) < n and guard < 4 * size:
            h = self.clock_hand
            self.clock_hand = (h + 1) % size
            guard += 1
            if h in chosen:
                continue
            if self.ref_bit[h]:
                self.ref_bit[h] = False
            else:
                victims.append(h)
                chosen.add(h)
        for h in range(size):                      # exhaustive fallback
            if len(victims) >= n:
                break
            if h not in chosen:
                victims.append(h)
                chosen.add(h)
        return np.asarray(victims, dtype=np.int64)

    def _admit(self, cluster_ids: np.ndarray, payload: np.ndarray
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if self.passthrough:
            return None
        # dedupe (a cluster may be requested twice before updates apply) in
        # FIRST-REQUESTED order: np.unique re-sorts by cluster id, so a
        # capacity clip below would drop by id rather than request order —
        # re-sorting the unique indices restores arrival order.
        _, uniq = np.unique(cluster_ids, return_index=True)
        uniq = np.sort(uniq)
        cluster_ids, payload = cluster_ids[uniq], payload[uniq]
        fresh = self.table.cache_slot[cluster_ids] < 0
        cluster_ids, payload = cluster_ids[fresh], payload[fresh]
        if len(cluster_ids) == 0:
            return None
        # one assemble may request more unique clusters than the cache holds
        # (tiny caches / huge retrieval zones): admit only what fits — the
        # overflow stays host-resident and will miss again, which is correct.
        n_cap = len(self.cache_owner)
        if len(cluster_ids) > n_cap:
            cluster_ids, payload = cluster_ids[:n_cap], payload[:n_cap]
        victims = self._victims(len(cluster_ids))
        evicted = self.cache_owner[victims]
        live = evicted >= 0
        self.table.cache_slot[evicted[live]] = -1
        self.cache[victims] = payload
        self.cache_owner[victims] = cluster_ids
        self.table.cache_slot[cluster_ids] = victims
        self.stamp[victims] = self.tick
        self.ref_bit[victims] = True
        return victims, cluster_ids, payload
