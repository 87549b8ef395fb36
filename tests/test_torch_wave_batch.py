"""The offload plane's batched per-layer wave buffers
(``core/wave_batch.py::WaveBufferBatch``, through the engine's own
``_OffloadPlane._translate`` / ``_drain_admissions``) against B x H port
``WaveBuffer``s driven per row and head as the plane drove them before it
batched them (the loop below), on seeded sequences of decode steps.

Each case walks two layers through admissions (a slot replaced with
admissions still queued for it), inactive rows, dead ids (at or past a
row's cluster count), repeated ids in one call (pending hits), segment
flushes through ``store_rows``, under one policy, cache size, deadline and
transport, and requires both sides to give the same slot ids and validity,
miss ids and rows, queued admission ids and rows, trace events (the cache
update's kind, each drain's ``queued``), dropped and failed slots, every
``BufferStats`` field of every buffer and the same mapping tables. Every
case runs with the payload checksums of the native routine
(``core/row_crc.py``) and, as ``<case>-zlib``, with the row-by-row ``zlib``
path the plane takes on a host without the routine's fold; both checksum
the same rows the same number of times.
"""
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import row_crc, wave_batch
from repro_torch.core.wave_batch import WaveBufferBatch
from repro_torch.core.wave_buffer import (BufferStats, FatalTransportError,
                                          FaultProfile, FaultyTransport,
                                          LinkTransport, WaveBuffer)
from repro_torch.serving.engine import _OffloadPlane

L, B, H, M, D, R = 2, 3, 2, 24, 5, 6
STEPS = 14

# name -> (policy, cache slots, deadline, fault profile, raw store write)
CASES = {f"{p}-c{c}": (p, c, None, None, False)
         for p in ("lru", "fifo", "clock") for c in (0, 1, 4, 8)}
CASES.update({
    "deadline-0": ("lru", 4, 0.0, None, False),
    "deadline-negative": ("clock", 4, -1.0, None, False),
    "raw-write": ("lru", 4, None, None, True),
    "raw-write-deadline": ("fifo", 4, 0.0025, None, True),
    "faulty": ("lru", 4, 0.01, FaultProfile(
        transient=0.2, corrupt=0.1, spike=0.3, latency_s=0.001, seed=3),
        False),
    "fatal": ("lru", 4, None, FaultProfile(fatal=0.04, transient=0.1,
                                           seed=5), False),
})


# --------------------------------------------------------------- the loop
def _loop_translate(bufs, ids, active, ncl, failed, C, deadline):
    """One layer's translate over per-buffer ``WaveBuffer``s, per row and
    head. Returns (slots_valid, miss, dropped)."""
    sv = np.zeros((2,) + ids.shape, np.int32)
    idx_slots, valid = sv[0], sv[1]
    valid[:] = 1
    stage = C + np.arange(R)
    mb, mh, ms, rows = [], [], [], []
    dropped = 0
    for b in range(B):
        if not active[b] or bufs[b] is None or b in failed:
            continue
        dead = ids[b] >= ncl[b]
        for h in range(H):
            buf = bufs[b][h]
            live_j = np.where(~dead[h])[0]
            idx_slots[b, h] = stage
            if len(live_j) == 0:
                continue
            try:
                slot, hit, payload, ok = buf.translate(ids[b, h, live_j],
                                                       deadline_s=deadline)
            except FatalTransportError as e:
                failed[b] = str(e)
                break
            idx_slots[b, h, live_j] = np.where(hit, slot, stage[live_j])
            valid[b, h, live_j[~ok]] = 0
            dropped += int((~ok).sum())
            fetched = ~hit & ok
            if fetched.any():
                j = live_j[fetched]
                mb.append(np.full(len(j), b))
                mh.append(np.full(len(j), h))
                ms.append(stage[j])
                rows.append(payload[fetched])
    if not rows:
        return sv, None, dropped
    return sv, (np.stack([np.concatenate(mb), np.concatenate(mh),
                          np.concatenate(ms)]), np.concatenate(rows)), dropped


def _loop_drain(bufs, active):
    ab, ah, a_s, rows = [], [], [], []
    for b in range(B):
        if not active[b] or bufs[b] is None:
            continue
        for h in range(H):
            for vict, _ids, payload in bufs[b][h].apply_updates():
                ab.append(np.full(len(vict), b))
                ah.append(np.full(len(vict), h))
                a_s.append(vict)
                rows.append(payload)
    return None if not rows else (
        np.stack([np.concatenate(ab), np.concatenate(ah),
                  np.concatenate(a_s)]), np.concatenate(rows))


class _Loop:
    """L x B x H ``WaveBuffer``s and the plane's queue, the loop way."""

    def __init__(self, C, policy, transport):
        self.C, self.policy, self.transport = C, policy, transport
        self.bufs = [[None] * B for _ in range(L)]
        self.pending = [None] * L
        self.failed, self.dropped = {}, 0
        self.retired = BufferStats()

    def admit(self, l, b, host):
        for buf in self.bufs[l][b] or ():
            self.retired.merge(buf.stats)
        self.bufs[l][b] = [WaveBuffer(host[h], cache_clusters=self.C,
                                      policy=self.policy,
                                      transport=self.transport)
                           for h in range(H)]
        if self.pending[l] is not None:
            ids, rows = self.pending[l]
            keep = ids[0] != b
            self.pending[l] = (ids[:, keep], rows[keep])

    def store_rows(self, l, b, start, rows):
        for h in range(H):
            self.bufs[l][b][h].store_rows(start, rows[h])

    def step(self, l, ids, active, ncl, deadline, events):
        sv, miss, dropped = _loop_translate(self.bufs[l], ids, active, ncl,
                                            self.failed, self.C, deadline)
        self.dropped += dropped
        queued = self.pending[l]
        events.append(("cache_stage" if queued is None else "cache_upd", l))
        self.pending[l] = _loop_drain(self.bufs[l], active)
        events.append(("drain_admissions", l, self.pending[l] is not None))
        return sv, miss, queued



# -------------------------------------------------------------- the batch
class _Batched:
    """The engine's own plane methods over ``WaveBufferBatch``es, on a
    stand-in for the plane's other state."""

    def __init__(self, C, policy, transport, deadline):
        h_rows = torch.zeros((L, 2, B * H * R, D))
        self.plane = SimpleNamespace(
            layers=[WaveBufferBatch(B, H, M, D, C, policy=policy,
                                    transport=transport)
                    for _ in range(L)],
            failed_slots={}, ncl=None, fetch_deadline_s=deadline, C=C,
            h_rows=h_rows, host_rows=h_rows.numpy(), pending_adm=[None] * L,
            dropped_cluster_steps=0,
            _counts=dict(steps=0, gathered_rows=0, per_miss_rows=0))
        self.retired = BufferStats()
        self.sent = {True: 0, False: 0}     # queued rows in the staging?

    def admit(self, l, b, host):
        old = self.plane.layers[l].admit(b, host)
        if old is not None:
            self.retired.merge(old)
        _OffloadPlane._drop_queued(self.plane, l, b)

    def store_rows(self, l, b, start, rows):
        self.plane.layers[l].store_rows(b, start, rows)

    def step(self, l, ids, active, ncl, deadline, events):
        p = self.plane
        p.ncl = ncl
        sv, miss = _OffloadPlane._translate(p, l, ids, active)
        queued = p.pending_adm[l]
        events.append(("cache_stage" if queued is None else "cache_upd", l))
        # as ``load`` reads them, before the drain refills the buffers
        miss = miss if miss is None else (miss[0], miss[1].numpy().copy())
        if queued is not None:
            rows = queued[1].numpy()
            self.sent[np.shares_memory(rows, p.host_rows)] += 1
            queued = (queued[0], rows.copy())
        events.append(("drain_admissions", l,
                       _OffloadPlane._drain_admissions(p, l)))
        return sv, miss, queued


def _transport(profile):
    return LinkTransport() if profile is None else FaultyTransport(profile)


def _eq(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _run(case):
    policy, C, deadline, profile, raw = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    loop = _Loop(C, policy, _transport(profile))
    batch = _Batched(C, policy, _transport(profile), deadline)
    sides = (loop, batch)
    ncl = np.zeros(B, np.int64)
    alive = np.zeros(B, bool)
    events = ([], [])
    fatal = 0

    def admit(b):
        n = int(rng.integers(6, 14))
        for l in range(L):
            host = rng.standard_normal((H, M, D)).astype(np.float32)
            for side in sides:      # both hold the same host arrays
                side.admit(l, b, host)
        ncl[b], alive[b] = n, True

    admit(0)
    admit(1)
    for t in range(STEPS):
        if t == 5:
            admit(2)
        if t == 8:
            admit(0)            # a replaced slot, admissions queued for it
        if t in (4, 10):        # a segment flush appends 2 clusters a row
            for b in np.flatnonzero(alive & (ncl + 2 <= M)):
                for l in range(L):
                    rows = rng.standard_normal((H, 2, D)).astype(np.float32)
                    for side in sides:
                        side.store_rows(l, b, int(ncl[b]), rows)
                ncl[b] += 2
        if raw and t == 6:      # bypasses store_rows: stale checksums
            for side in sides[:1]:
                for b in (0, 1):
                    side.bufs[0][b][1].kv_host[:3, 0] += 1.0
        active = alive & (rng.random(B) < 0.8)
        batch.plane._counts["steps"] = t
        for l in range(L):
            # ids from a working set a little past the live clusters: hits,
            # misses and dead ids; on odd steps with repeats (pending hits),
            # on even ones distinct, as a ranking returns them
            if t % 2:
                ids = rng.integers(0, ncl[:, None, None] + 3, (B, H, R))
                ids[:, :, -1] = ids[:, :, 0]
            else:
                past = np.arange(M) >= ncl[:, None, None] + 3
                ids = np.argsort(rng.random((B, H, M)) + past, -1)[..., :R]
            for side, ev in zip(sides, events):
                ev.append(("translate", t, l))
            out_loop = loop.step(l, ids, active, ncl, deadline, events[0])
            out_batch = batch.step(l, ids, active, ncl, deadline, events[1])
            assert np.array_equal(out_loop[0], out_batch[0]), (t, l)
            assert _eq(out_loop[1], out_batch[1]), (t, l, "miss")
            assert _eq(out_loop[2], out_batch[2]), (t, l, "admissions")
        assert loop.failed == batch.plane.failed_slots
        assert loop.dropped == batch.plane.dropped_cluster_steps
        for b in list(loop.failed):          # the serve loop ends the request
            alive[b] = False
            fatal += 1
        loop.failed.clear()
        batch.plane.failed_slots.clear()
    assert events[0] == events[1]
    return loop, batch, fatal


class _CountingZlib:
    """``zlib`` as ``core/wave_batch.py`` sees it, counting crc32 calls."""

    def __init__(self):
        self.calls = 0

    def crc32(self, data):
        self.calls += 1
        return zlib.crc32(data)


def _zlib_run(case, monkeypatch):
    """``_run`` with the plane's row-by-row ``zlib`` path (as on a host
    without the fold). Returns ``_run``'s result and its crc32 calls."""
    with monkeypatch.context() as mp:
        counter = _CountingZlib()
        mp.setattr(row_crc, "native", lambda: None)
        mp.setattr(wave_batch, "zlib", counter)
        return _run(case), counter.calls


@pytest.mark.parametrize(
    "case,crc", [pytest.param(c, "native", id=c) for c in CASES]
    + [pytest.param(c, "zlib", id=f"{c}-zlib") for c in CASES])
def test_batched_plane_matches_per_buffer_loop(case, crc, monkeypatch):
    if crc == "native":
        assert row_crc.native() is not None, "no native routine on x86-64"
        loop, batch, fatal = _run(case)
        # the same rows checksummed as by zlib, all natively
        want = (_zlib_run(case, monkeypatch)[1], 0)
    else:
        (loop, batch, fatal), calls = _zlib_run(case, monkeypatch)
        want = (0, calls)
    crc_rows = tuple(sum(getattr(layer, key) for layer in batch.plane.layers)
                     for key in ("native_crc_rows", "zlib_crc_rows"))
    assert crc_rows == want
    # four admissions (rows 0, 1, 2, then 0 again) checksum every row of
    # every layer's store; flushes and gathers add theirs
    assert sum(crc_rows) >= 4 * L * H * M
    policy, C, deadline, profile, raw = CASES[case]
    assert loop.retired == batch.retired and loop.retired.lookups > 0
    over_link = loop.retired.bytes_over_link
    for l in range(L):
        layer = batch.plane.layers[l]
        for b in range(B):
            for h in range(H):
                want = loop.bufs[l][b][h]
                got = BufferStats(*map(int, layer.stats[b, h]))
                assert want.stats == got, (l, b, h)
                np.testing.assert_array_equal(want.table.cache_slot,
                                              layer.cache_slot[b, h])
                np.testing.assert_array_equal(want.cache_owner,
                                              layer.owner[b, h])
                np.testing.assert_array_equal(want.stamp, layer.stamp[b, h])
                np.testing.assert_array_equal(want.ref_bit,
                                              layer.ref_bit[b, h])
                np.testing.assert_array_equal(want.checksums,
                                              layer.checksums[b, h])
                assert want.tick == layer.tick[b, h]
                assert want.clock_hand == layer.hand[b, h]
                over_link += want.stats.bytes_over_link
    # every fresh row through the gather under the production transport,
    # through the per-miss fetch under a fault profile
    counts = batch.plane._counts
    rows = over_link // (D * 4)
    if profile is None:
        assert (counts["gathered_rows"], counts["per_miss_rows"]) == (rows, 0)
    else:
        assert (counts["gathered_rows"], counts["per_miss_rows"]) == (0, rows)
        assert rows > 0
    stats = [loop.bufs[l][b][h].stats for l in range(L) for b in range(B)
             for h in range(H)]
    if deadline is None or deadline >= 0:       # else no fetch lands
        assert sum(s.pending_hits for s in stats) > 0
        assert (sum(s.hits for s in stats) > 0) == (C > 0)
    if raw:
        assert sum(s.corrupt_fetches for s in stats) > 0
    if C >= R and profile is None and deadline is None and not raw:
        # admissions sent from the staging, and copied out of it
        assert batch.sent[True] > 0 and batch.sent[False] > 0
    if deadline is not None and deadline < 0:
        assert sum(s.failed_fetches for s in stats) == \
            sum(s.misses for s in stats) > 0
    assert (fatal > 0) == (case == "fatal")
