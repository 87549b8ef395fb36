"""One layer's B x H wave buffers as stacked arrays (paper Sec. 4.3).

The serve engine's offload plane keeps one ``WaveBufferBatch`` per layer
where it kept B x H ``WaveBuffer`` objects (``core/wave_buffer.py``): the
mapping tables, LRU stamps, ticks, reference bits, clock hands, owners and
``BufferStats`` of every (row, head) buffer are rows of a few arrays, and a
decode step's ``translate`` and ``drain`` update them all at once. Every
buffer behaves as its ``WaveBuffer`` would, driven in the engine's order
(each ``translate`` followed by one ``drain``): the same hits, pending hits,
fetches, failures, victims, admissions and counters, and each fetched row's
zlib crc32 checked against the checksum stored with it
(``tests/test_torch_wave_batch.py`` holds it to B x H ``WaveBuffer``s).

The host stores are the rows' packed payloads ``[K | V | pos]``, held by
reference, one (H, M, D) array per admitted row. There is no host mirror
of the cache: the serve engine's device block cache is the only copy.

Two fetch paths share the bookkeeping and differ in how misses are fetched;
the transport the batch was built with decides:

* the production ``LinkTransport`` (an infallible zero-latency view of the
  store): every miss of the layer is gathered with one indexed copy per
  row into the caller's staging, in (row, head, position) order, and each
  fresh row's crc32 is verified there (one native pass a row of the batch,
  each fresh row checksummed right after its copy). A buffer with a
  mismatch (a raw store write that bypassed ``store_rows``) has its misses
  replayed through
  the per-miss loop, which gives the reference's retries, corrupt and
  failed counts, ``ok`` mask and virtual deadline; its failed rows leave
  the staging.
* any other transport (``FaultyTransport``, scripted ones), and a negative
  deadline: the per-miss ``fetch`` with retries, backoff and the per-call
  deadline budget, in the reference's order (rows, then heads, then
  positions), since each draw of a seeded transport changes the next.

A ``Translation`` says how many fresh rows each path fetched.

The payload checksums of ``admit``, ``store_rows`` and the gather are
computed many rows a call by the native routine of ``core/row_crc.py``,
the same values as ``zlib.crc32``; on a host without its carry-less-multiply
fold, row by row with ``zlib``. ``native_crc_rows`` and ``zlib_crc_rows``
count the rows each way. The per-miss ``fetch`` checks one row at a time
with ``zlib`` either way.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.core import row_crc
from repro_torch.core.wave_buffer import (BufferStats, FatalTransportError,
                                          LinkTransport, TransientFault, _crc)

STAT_FIELDS = tuple(f.name for f in dataclasses.fields(BufferStats))
_S = {name: i for i, name in enumerate(STAT_FIELDS)}


def _stats(counts: np.ndarray) -> BufferStats:
    """A ``BufferStats`` from a vector of counters in ``STAT_FIELDS`` order."""
    return BufferStats(*(int(v) for v in counts))


class Translation(NamedTuple):
    """One layer's ``translate``, per (row, head, position) unless noted.

    ``visited`` (B, H): buffers the walk reached (a row's heads past a
    fatal fault are not). ``slot`` (the cache slot of a hit, else -1),
    ``failed`` (a live miss whose fetch failed) and ``fetched`` (a live
    miss whose row is in the staging) cover the live ids of the visited
    buffers whose call stands (not a head that raised). ``n``: staging
    rows written, in the flat order of ``fetched``. ``fatal``: row -> the
    fatal fault's message. ``gathered`` / ``per_miss``: the rows the
    gather / the per-miss fetch brought over the link (one of them is 0).
    """
    visited: np.ndarray
    slot: np.ndarray
    failed: np.ndarray
    fetched: np.ndarray
    n: int
    fatal: Dict[int, str]
    gathered: int
    per_miss: int


class Admissions(NamedTuple):
    """One layer's applied admissions, grouped by buffer in (row, head)
    order: cache slot ``slots[i]`` of buffer (``rows[i]``, ``heads[i]``)
    now holds cluster ``ids[i]``, whose payload is row ``src[i]`` of the
    last translate's ``out`` (increasing in i)."""
    rows: np.ndarray
    heads: np.ndarray
    slots: np.ndarray
    ids: np.ndarray
    src: np.ndarray


class WaveBufferBatch:
    """The B x H wave buffers of one layer: ``cache_clusters`` device-cache
    slots each over an (M, D) host store of packed payload rows."""

    def __init__(self, B: int, H: int, M: int, D: int, cache_clusters: int,
                 policy: str = "lru",
                 transport: Optional[LinkTransport] = None,
                 max_retries: int = 2, backoff_s: float = 1e-3):
        if policy not in ("lru", "fifo", "clock"):
            raise ValueError(f"unknown cache policy {policy!r}")
        if cache_clusters < 0:
            raise ValueError(f"cache_clusters must be >= 0, got "
                             f"{cache_clusters}")
        C = cache_clusters
        self.B, self.H, self.M, self.D, self.C = B, H, M, D, C
        self.passthrough = C == 0       # every lookup misses, nothing admitted
        self.policy = policy
        self.transport = transport if transport is not None \
            else LinkTransport()
        self.max_retries, self.backoff_s = max_retries, backoff_s
        self.bytes_per_cluster = D * 4
        self.crc = row_crc.native()     # None: zlib, row by row
        self.native_crc_rows = self.zlib_crc_rows = 0
        self.stores: List[Optional[np.ndarray]] = [None] * B   # (H, M, D) f32
        self.checksums = np.zeros((B, H, M), np.uint64)
        self.cache_slot = np.full((B, H, M), -1, np.int64)
        self.owner = np.full((B, H, C), -1, np.int64)
        self.stamp = np.zeros((B, H, C), np.int64)
        self.ref_bit = np.zeros((B, H, C), bool)
        self.tick = np.zeros((B, H), np.int64)
        self.hand = np.zeros((B, H), np.int64)
        self.stats = np.zeros((B, H, len(STAT_FIELDS)), np.int64)
        # the last translate's fresh fetches, waiting for ``drain``:
        # (rows, heads, ids, staging indices), grouped by buffer
        self._pending: Optional[tuple] = None

    # ------------------------------------------------------------ stores
    @property
    def admitted(self) -> np.ndarray:
        """(B,) rows holding a store."""
        return np.array([s is not None for s in self.stores])

    def admit(self, b: int, host: np.ndarray) -> Optional[BufferStats]:
        """Row ``b``'s (H, M, D) host stores, held by reference, with fresh
        tables and their checksums. Returns the previous occupant's
        counters summed over its heads (None on the row's first
        admission)."""
        if host.shape != (self.H, self.M, self.D) \
                or host.dtype != np.float32 or not host.flags.c_contiguous:
            raise ValueError(f"row store {host.shape} {host.dtype}: want a "
                             f"C-contiguous {(self.H, self.M, self.D)} "
                             f"float32")
        old = _stats(self.stats[b].sum(0)) if self.stores[b] is not None \
            else None
        self.stores[b] = host
        self.checksums[b] = self._checksum(host.reshape(-1, self.D)) \
            .reshape(self.H, self.M)
        self.cache_slot[b] = -1
        self.owner[b] = -1
        self.stamp[b] = 0
        self.ref_bit[b] = False
        self.tick[b] = 0
        self.hand[b] = 0
        self.stats[b] = 0
        return old

    def store_rows(self, b: int, start: int, rows: np.ndarray) -> None:
        """Write (H, k, D) payload rows ``[start, start + k)`` into row
        ``b``'s stores and refresh their checksums (``WaveBuffer.store_rows``
        for every head)."""
        store = self.stores[b]
        k = rows.shape[1]
        store[:, start:start + k] = rows
        for h in range(self.H):
            self.checksums[b, h, start:start + k] = \
                self._checksum(store[h, start:start + k])

    def _checksum(self, rows: np.ndarray) -> np.ndarray:
        """The crc32 of each of the (n, D) C-contiguous ``rows``: one native
        call, else one ``zlib`` call a row."""
        self._count(len(rows))
        if self.crc is not None:
            return self.crc.rows(rows)
        return np.fromiter((zlib.crc32(row) for row in rows), np.uint64,
                           len(rows))

    def _count(self, n: int) -> None:
        if self.crc is None:
            self.zlib_crc_rows += n
        else:
            self.native_crc_rows += n

    def total(self) -> BufferStats:
        """Every buffer's counters summed."""
        return _stats(self.stats.sum((0, 1)))

    # ------------------------------------------------------------ translate
    def translate(self, ids: np.ndarray, rows: np.ndarray, n_live: np.ndarray,
                  deadline_s: Optional[float], out: np.ndarray
                  ) -> Translation:
        """Look up the (B, H, r) ``ids`` of the rows in ``rows`` (B,) bool;
        an id at or past its row's ``n_live`` (B,) cluster count is dead and
        never looked up, and a buffer whose ids are all dead is not called.
        Each fetched miss row is written to ``out`` (at least B H r rows of
        D) in (row, head, position) order. ``deadline_s``: each buffer's
        virtual budget for its misses (None: unbounded). A
        ``FatalTransportError`` fails the row: the walk skips its later
        heads (``Translation.fatal``); the other rows go on."""
        if self._pending is not None:
            raise RuntimeError("translate before the last translate's "
                               "admissions were drained")
        B, H, r = ids.shape
        live = rows[:, None, None] & (ids < n_live[:, None, None])
        if ((ids < 0) & live).any():
            raise ValueError(f"cluster ids out of range: "
                             f"{np.unique(ids[(ids < 0) & live])[:8].tolist()}")
        bi = np.arange(B)[:, None, None]
        hi = np.arange(H)[None, :, None]
        slot = np.where(live, self.cache_slot[bi, hi, np.where(live, ids, 0)],
                        -1)
        hit = slot >= 0
        miss = live & ~hit
        called = live.any(-1)
        visited = np.repeat(rows[:, None], H, 1)
        gather = type(self.transport) is LinkTransport and \
            (deadline_s is None or deadline_s >= 0)
        if gather:
            ok, fresh = self._gather(ids, miss, deadline_s, out)
            fatal_head, fatal = np.zeros((B, H), bool), {}
            gathered, per_miss = len(fresh[0]), 0
        else:
            ok, fatal_head, fresh, fatal, per_miss = self._walk(
                ids, miss, called, visited, deadline_s, out, write=True)
            gathered = 0
        # the calls' bookkeeping: a called buffer's tick, lookups and
        # stamps count, the head that raised included
        calls = called & visited
        look = live & calls[..., None]
        self.tick += calls
        st = self.stats
        nh = (hit & look).sum(-1)
        st[..., _S["lookups"]] += look.sum(-1)
        st[..., _S["hits"]] += nh
        st[..., _S["misses"]] += (miss & look).sum(-1)
        st[..., _S["bytes_from_cache"]] += nh * self.bytes_per_cluster
        hb, hh, hj = np.nonzero(hit & look)
        self.stamp[hb, hh, slot[hb, hh, hj]] = self.tick[hb, hh]
        self.ref_bit[hb, hh, slot[hb, hh, hj]] = True
        keep = live & (visited & ~fatal_head)[..., None]
        fetched = miss & ok & keep
        if not self.passthrough and len(fresh[0]):
            at = np.cumsum(fetched.reshape(-1)) - 1     # staging row
            self._pending = (fresh[0], fresh[1], ids[fresh],
                             at[np.ravel_multi_index(fresh, ids.shape)])
        return Translation(visited, np.where(hit & keep, slot, -1),
                           miss & ~ok & keep, fetched, int(fetched.sum()),
                           fatal, gathered, per_miss)

    def _gather(self, ids, miss, deadline_s, out):
        """Every miss's row copied into ``out`` by one indexed copy per row
        of the batch, and each fresh row's crc32 verified there. Buffers
        with a mismatch are replayed through ``_walk`` (their rows are in
        ``out`` already), and their failed rows dropped from it. Returns
        (ok, the fresh positions)."""
        B, H, r = ids.shape
        mb, mh, mj = np.nonzero(miss)
        cid = ids[mb, mh, mj]
        n = len(mb)
        buf = mb * H + mh
        # a repeat of a cluster within one call is a pending hit: the first
        # occurrence is fetched, the rest carry the same row
        is_fresh = np.zeros(n, bool)
        is_fresh[np.unique(buf * self.M + cid, return_index=True)[1]] = True
        bounds = np.searchsorted(mb, np.arange(B + 1))
        row = (mh * self.M + cid).astype(np.int64, copy=False)
        crc = np.zeros(n, np.uint32)
        for b in range(B):
            lo, hi = bounds[b], bounds[b + 1]
            if hi == lo:
                continue
            store = self.stores[b].reshape(H * self.M, self.D)
            if self.crc is not None:
                # one pass: each fresh row checksummed right after its copy
                self.crc.gather(store, row[lo:hi], out[lo:hi],
                                is_fresh[lo:hi], crc[lo:hi])
            else:
                np.take(store, row[lo:hi], axis=0, out=out[lo:hi],
                        mode="clip")
        fk = np.flatnonzero(is_fresh)
        if self.crc is None:
            crc[fk] = np.fromiter((zlib.crc32(out[k]) for k in fk),
                                  np.uint32, len(fk))
        self._count(len(fk))
        crc = crc[fk]
        clean = np.ones(B * H, bool)
        clean[buf[fk[crc != self.checksums[mb[fk], mh[fk], cid[fk]]]]] = False
        good = clean[buf]
        per = lambda m: np.bincount(buf[m], minlength=B * H).reshape(B, H)
        n_fresh, n_rep = per(is_fresh & good), per(~is_fresh & good)
        bpc = self.bytes_per_cluster
        st = self.stats
        st[..., _S["bytes_over_link"]] += n_fresh * bpc
        st[..., _S["pending_hits"]] += n_rep
        st[..., _S["bytes_from_pending"]] += n_rep * bpc
        if not self.passthrough:
            st[..., _S["updates_deferred"]] += n_fresh > 0
        sel = is_fresh & good
        fresh = (mb[sel], mh[sel], mj[sel])
        ok = np.ones(ids.shape, bool)
        if not clean.all():
            redo = ~clean.reshape(B, H)
            ok, _, again, _, _ = self._walk(ids, miss & redo[..., None],
                                            redo, redo.copy(), deadline_s,
                                            out, write=False)
            flat = np.sort(np.concatenate(
                [np.ravel_multi_index(f, ids.shape) for f in (fresh, again)]))
            fresh = np.unravel_index(flat, ids.shape)
            kept = ok[mb, mh, mj]
            out[:int(kept.sum())] = out[:n][kept]
        return ok, fresh

    def _walk(self, ids, miss, called, visited, deadline_s, out,
              write: bool):
        """The per-miss fetch, buffer by buffer in (row, head) order and
        position by position, as ``WaveBuffer.translate`` fetches: a repeat
        within the call is a pending hit; a failed fetch stays out of the
        pending set, so a repeat fetches again. ``write``: each fetched row
        is written to ``out`` in that order (else it lies there already).
        A fatal fault marks the row's later heads unvisited, in ``visited``
        itself. Returns (ok, the heads that raised, the fresh positions,
        row -> fatal message, the rows fetched: those of a head that raised
        too, which leave the staging)."""
        B, H, r = ids.shape
        ok = np.ones(ids.shape, bool)
        fatal_head = np.zeros((B, H), bool)
        fatal: Dict[int, str] = {}
        fresh: List[int] = []           # flat (row, head, position) indices
        bpc = self.bytes_per_cluster
        k = got_rows = 0
        for b, h in zip(*np.nonzero(called & visited)):
            if not visited[b, h]:       # past a fatal fault in this row
                continue
            st = self.stats[b, h]
            got: Dict[int, int] = {}    # cluster -> its staging row
            mine: List[int] = []
            k0, elapsed = k, 0.0
            try:
                for j in np.flatnonzero(miss[b, h]):
                    c = int(ids[b, h, j])
                    if c in got:
                        st[_S["pending_hits"]] += 1
                        st[_S["bytes_from_pending"]] += bpc
                        if write:
                            out[k] = out[got[c]]
                        k += 1
                        continue
                    budget = None if deadline_s is None \
                        else deadline_s - elapsed
                    payload, spent = self._fetch(b, h, c, budget)
                    elapsed += spent
                    if payload is None:
                        ok[b, h, j] = False
                        st[_S["failed_fetches"]] += 1
                        continue
                    if write:
                        out[k] = payload
                    got[c] = k
                    mine.append((b * H + h) * r + j)
                    st[_S["bytes_over_link"]] += bpc
                    got_rows += 1
                    k += 1
            except FatalTransportError as e:
                # the row dies: its later heads are not called, and this
                # head's rows leave the staging
                fatal[int(b)] = str(e)
                fatal_head[b, h] = True
                visited[b, h + 1:] = False
                k = k0
                continue
            if mine and not self.passthrough:
                st[_S["updates_deferred"]] += 1
            fresh += mine
        return ok, fatal_head, np.unravel_index(
            np.asarray(fresh, np.int64), ids.shape), fatal, got_rows

    def _fetch(self, b, h, cid, budget):
        """``WaveBuffer._fetch`` on buffer (b, h): crc verification,
        bounded retry with exponential virtual backoff, the virtual
        deadline. ``FatalTransportError`` propagates."""
        st = self.stats[b, h]
        store = self.stores[b][h]
        spent = 0.0
        for attempt in range(self.max_retries + 1):
            if attempt:
                st[_S["retries"]] += 1
                spent += self.backoff_s * (2 ** (attempt - 1))
            if budget is not None and spent > budget:
                return None, spent              # overdue before issuing
            try:
                payload, lat = self.transport.fetch(store, cid)
            except TransientFault:
                st[_S["faults"]] += 1
                continue
            spent += lat
            if budget is not None and spent > budget:
                return None, spent              # arrived past the deadline
            if _crc(payload) != int(self.checksums[b, h, cid]):
                st[_S["corrupt_fetches"]] += 1
                continue
            return payload, spent
        return None, spent

    # ------------------------------------------------------------ drain
    def drain(self) -> Optional[Admissions]:
        """Apply the last translate's deferred admissions, every buffer at
        once (``WaveBuffer.apply_updates``): victims by the policy and the
        tables updated. The admitted rows stay where the translate put
        them (``Admissions.src``). None when nothing was admitted."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        pb, ph, ids, src = pending
        # each buffer's fresh ids are unique and still unmapped; a buffer
        # admits at most C of them, in the order they were requested
        buf = pb * self.H + ph
        ub, start, k = np.unique(buf, return_index=True, return_counts=True)
        rank = np.arange(len(buf)) - np.repeat(start, k)
        sel = rank < self.C
        pb, ph, ids, src = pb[sel], ph[sel], ids[sel], src[sel]
        k = np.minimum(k, self.C)
        vb, vh = np.divmod(ub, self.H)
        victims = self._victims(vb, vh, k)
        ev = self.owner[pb, ph, victims]
        gone = ev >= 0
        self.cache_slot[pb[gone], ph[gone], ev[gone]] = -1
        self.owner[pb, ph, victims] = ids
        self.cache_slot[pb, ph, ids] = victims
        self.stamp[pb, ph, victims] = self.tick[pb, ph]
        self.ref_bit[pb, ph, victims] = True
        return Admissions(pb, ph, victims, ids, src)

    def _victims(self, vb, vh, k) -> np.ndarray:
        """Victim slots of buffers (vb[i], vh[i]), k[i] each, concatenated:
        what ``WaveBuffer._victims`` picks for each buffer."""
        C = self.C
        first = np.arange(C)[None, :] < k[:, None]
        if self.policy == "lru":
            # row-wise argsort: each row sorted as the per-buffer argsort
            # sorts it, ties included
            return np.argsort(self.stamp[vb, vh], axis=-1)[first]
        if self.policy == "fifo":
            v = (self.hand[vb, vh][:, None] + np.arange(C)[None, :]) % C
            self.hand[vb, vh] = (self.hand[vb, vh] + k) % C
            return v[first]
        out = []
        for b, h, n in zip(vb, vh, k):
            out.append(self._clock(b, h, int(n)))
        return np.concatenate(out)

    def _clock(self, b, h, n) -> np.ndarray:
        """Second-chance victims of buffer (b, h), unique within the call."""
        ref = self.ref_bit[b, h]
        size = self.C
        victims: list = []
        chosen = set()
        guard = 0
        while len(victims) < n and guard < 4 * size:
            x = int(self.hand[b, h])
            self.hand[b, h] = (x + 1) % size
            guard += 1
            if x in chosen:
                continue
            if ref[x]:
                ref[x] = False
            else:
                victims.append(x)
                chosen.add(x)
        for x in range(size):                      # exhaustive fallback
            if len(victims) >= n:
                break
            if x not in chosen:
                victims.append(x)
                chosen.add(x)
        return np.asarray(victims, dtype=np.int64)
